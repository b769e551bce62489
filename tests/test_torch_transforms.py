"""The port's ``vision.transforms`` and ``vision.datasets`` against the
JAX package's.

Every transform class and functional runs on the same seeded uint8 and
float images in both packages, Python's ``random`` and numpy's global
state seeded alike before each side: the outputs are bitwise equal, in
value, dtype and shape. ``FakeData`` is bitwise the JAX stream; the
``MNIST`` / ``FashionMNIST`` and ``Cifar10`` / ``Cifar100`` readers read
tiny files written here in the on-disk formats (idx, gzipped and not;
the python-pickle tarball) as the JAX readers do, and raise on a
missing file.
"""
import gzip
import io
import pickle
import random
import struct
import tarfile

import numpy as np
import pytest

from paddle_tpu.vision import datasets as JD
from paddle_tpu.vision import transforms as JT
from paddle_tpu_torch.vision import datasets as TD
from paddle_tpu_torch.vision import transforms as TT

MEAN, STD = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]


def _images():
    rs = np.random.RandomState(0)
    return {"uint8": (rs.rand(37, 45, 3) * 255).astype(np.uint8),
            "float": rs.rand(37, 45, 3).astype(np.float32)}


# name: a factory taking the transforms module
CLASSES = {
    "resize_short": lambda m: m.Resize(24),
    "resize_hw": lambda m: m.Resize((20, 33)),
    "resize_up": lambda m: m.Resize((64, 70)),
    "center_crop": lambda m: m.CenterCrop(21),
    "random_crop": lambda m: m.RandomCrop(19),
    "random_crop_pad": lambda m: m.RandomCrop((30, 30), padding=4),
    "hflip": lambda m: m.RandomHorizontalFlip(0.5),
    "vflip": lambda m: m.RandomVerticalFlip(0.5),
    "normalize_hwc": lambda m: m.Normalize(MEAN, STD, data_format="HWC"),
    "transpose": lambda m: m.Transpose(),
    "to_tensor": lambda m: m.ToTensor(),
    "to_tensor_hwc": lambda m: m.ToTensor(data_format="HWC"),
    "brightness": lambda m: m.BrightnessTransform(0.4),
    "contrast": lambda m: m.ContrastTransform(0.4),
    "saturation": lambda m: m.SaturationTransform(0.4),
    "hue": lambda m: m.HueTransform(0.2),
    "color_jitter": lambda m: m.ColorJitter(0.3, 0.3, 0.3, 0.1),
    "pad": lambda m: m.Pad((1, 2, 3, 4), fill=7),
    "pad_reflect": lambda m: m.Pad(3, padding_mode="reflect"),
    "grayscale": lambda m: m.Grayscale(3),
    "random_rotation": lambda m: m.RandomRotation(30),
    "random_rotation_expand": lambda m: m.RandomRotation(
        (10, 50), interpolation="bilinear", expand=True, fill=9),
    "random_affine": lambda m: m.RandomAffine(
        20, translate=(0.1, 0.2), scale=(0.8, 1.2), shear=(-5, 5, -3, 3)),
    "random_perspective": lambda m: m.RandomPerspective(prob=1.0),
    "random_resized_crop": lambda m: m.RandomResizedCrop(24),
    "random_erasing": lambda m: m.RandomErasing(prob=1.0, value=3),
    "compose_eval": lambda m: m.Compose([
        m.Resize(32), m.CenterCrop(28), m.ToTensor(), m.Normalize(MEAN, STD)]),
    "compose_train": lambda m: m.Compose([
        m.RandomResizedCrop(28), m.RandomHorizontalFlip(), m.ToTensor(),
        m.Normalize(MEAN, STD)]),
}

FUNCTIONALS = {
    "to_tensor": lambda m, x: m.to_tensor(x),
    "resize": lambda m, x: m.resize(x, (17, 23)),
    "normalize": lambda m, x: m.normalize(x.astype(np.float32), MEAN, STD,
                                          data_format="HWC"),
    "hflip": lambda m, x: m.hflip(x),
    "vflip": lambda m, x: m.vflip(x),
    "center_crop": lambda m, x: m.center_crop(x, (20, 30)),
    "crop": lambda m, x: m.crop(x, 3, 5, 10, 12),
    "adjust_brightness": lambda m, x: m.adjust_brightness(x, 1.3),
    "adjust_contrast": lambda m, x: m.adjust_contrast(x, 0.7),
    "adjust_saturation": lambda m, x: m.adjust_saturation(x, 1.4),
    "adjust_hue": lambda m, x: m.adjust_hue(x, -0.2),
    "to_grayscale": lambda m, x: m.to_grayscale(x),
    "pad": lambda m, x: m.pad(x, (2, 3)),
    "pad_edge": lambda m, x: m.pad(x, 2, padding_mode="edge"),
    "pad_symmetric": lambda m, x: m.pad(x, [1, 2, 3, 4],
                                        padding_mode="symmetric"),
    "erase": lambda m, x: m.erase(x, 2, 3, 5, 6, 0),
    "affine": lambda m, x: m.affine(x, 15.0, (2, -3), 1.1, (4.0, 2.0)),
    "affine_nearest": lambda m, x: m.affine(x, -30.0, (0, 0), 0.9, 3.0,
                                            interpolation="nearest"),
    "rotate": lambda m, x: m.rotate(x, 33),
    "rotate_expand": lambda m, x: m.rotate(x, 90, expand=True,
                                           interpolation="bilinear"),
    "perspective": lambda m, x: m.perspective(
        x, [(0, 0), (44, 0), (44, 36), (0, 36)],
        [(2, 1), (40, 3), (43, 33), (1, 35)]),
}


def _same(got, want):
    assert type(got) is type(want)
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def _seeded(fn, seed):
    random.seed(seed)
    np.random.seed(seed)
    return fn()


@pytest.mark.parametrize("kind", ["uint8", "float"])
@pytest.mark.parametrize("name", sorted(CLASSES))
def test_transform_bitwise(name, kind):
    img = _images()[kind]
    jt, tt = CLASSES[name](JT), CLASSES[name](TT)
    for seed in range(3):   # the random ones take several draws
        want = _seeded(lambda: jt(img.copy()), seed)
        got = _seeded(lambda: tt(img.copy()), seed)
        _same(got, want)


@pytest.mark.parametrize("kind", ["uint8", "float"])
@pytest.mark.parametrize("name", sorted(FUNCTIONALS))
def test_functional_bitwise(name, kind):
    img = _images()[kind]
    _same(FUNCTIONALS[name](TT, img.copy()), FUNCTIONALS[name](JT, img.copy()))


def test_normalize_chw_after_to_tensor():
    img = _images()["uint8"]
    chw = TT.ToTensor()(img)
    _same(TT.Normalize(MEAN, STD)(chw), JT.Normalize(MEAN, STD)(chw))
    assert chw.shape == (3, 37, 45) and chw.dtype == np.float32


def test_adjust_hue_range_raises():
    with pytest.raises(ValueError):
        TT.adjust_hue(_images()["uint8"], 0.7)


def test_fake_data_bitwise():
    kw = dict(num_samples=20, image_shape=(3, 8, 8), num_classes=7, seed=3)
    jd, td = JD.FakeData(**kw), TD.FakeData(**kw)
    assert len(td) == len(jd) == 20
    for i in range(len(td)):
        for a, b in zip(td[i], jd[i]):
            _same(a, b)
    tf = TD.FakeData(transform=TT.Normalize(0.5, 0.5), **kw)
    _same(tf[4][0], JD.FakeData(transform=JT.Normalize(0.5, 0.5), **kw)[4][0])


def _write_idx(path, arr, gz):
    head = struct.pack(">HBB", 0, 8, arr.ndim) + struct.pack(
        f">{arr.ndim}i", *arr.shape)
    op = gzip.open if gz else open
    with op(path, "wb") as f:
        f.write(head + arr.astype(np.uint8).tobytes())


@pytest.mark.parametrize("cls,gz", [("MNIST", True), ("FashionMNIST", False)])
def test_mnist_reader(tmp_path, cls, gz):
    rs = np.random.RandomState(5)
    imgs = (rs.rand(6, 28, 28) * 255).astype(np.uint8)
    lbls = rs.randint(0, 10, 6).astype(np.uint8)
    ext = ".gz" if gz else ""
    ip, lp = tmp_path / f"img{ext}", tmp_path / f"lbl{ext}"
    _write_idx(ip, imgs, gz)
    _write_idx(lp, lbls, gz)
    kw = dict(image_path=str(ip), label_path=str(lp), mode="test")
    td = getattr(TD, cls)(transform=TT.ToTensor(), **kw)
    jd = getattr(JD, cls)(transform=JT.ToTensor(), **kw)
    assert len(td) == len(jd) == 6
    for i in range(6):
        for a, b in zip(td[i], jd[i]):
            _same(a, b)
    np.testing.assert_array_equal(TD.MNIST(**kw)[2][0], imgs[2])
    assert TD.MNIST(**kw)[2][1].tolist() == [int(lbls[2])]
    with pytest.raises(FileNotFoundError):
        TD.MNIST(image_path=str(tmp_path / "absent"), label_path=str(lp))


def _write_cifar(path, n_batches, fine):
    rs = np.random.RandomState(6)
    key = b"fine_labels" if fine else b"labels"
    with tarfile.open(path, "w:gz") as tar:
        names = ([f"cifar/data_batch_{i}" for i in range(1, n_batches + 1)]
                 + ["cifar/test_batch"])
        for name in names:
            d = {b"data": (rs.rand(4, 3 * 32 * 32) * 255).astype(np.uint8),
                 key: rs.randint(0, 10, 4).tolist()}
            blob = pickle.dumps(d)
            info = tarfile.TarInfo(name)
            info.size = len(blob)
            tar.addfile(info, io.BytesIO(blob))


@pytest.mark.parametrize("cls,fine", [("Cifar10", False), ("Cifar100", True)])
@pytest.mark.parametrize("mode", ["train", "test"])
def test_cifar_reader(tmp_path, cls, fine, mode):
    path = str(tmp_path / "cifar.tar.gz")
    _write_cifar(path, 2, fine)
    td = getattr(TD, cls)(data_file=path, mode=mode)
    jd = getattr(JD, cls)(data_file=path, mode=mode)
    assert len(td) == len(jd) == (8 if mode == "train" else 4)
    for i in range(len(td)):
        for a, b in zip(td[i], jd[i]):
            _same(a, b)
    assert td[0][0].shape == (32, 32, 3)
    with pytest.raises(FileNotFoundError):
        TD.Cifar10(data_file=str(tmp_path / "absent.tar.gz"))
