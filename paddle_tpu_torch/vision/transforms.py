"""Image transforms: ``paddle_tpu/vision/transforms.py``, copied.

Host-side numpy preprocessing that runs in the ``io.DataLoader``'s
workers (as torchvision's runs on the host); only the collated batch
goes to the card. Images are HWC uint8 / float numpy arrays (CHW float
after ``ToTensor``). The random transforms draw from Python's ``random``
and numpy's global state, as the JAX package's do, so seeding both
generators alike gives both packages the same crops and flips.
``_resize_np`` is the JAX package's own separable bilinear resize over
``linspace`` grids (not cv2's or PIL's arithmetic).
"""
from __future__ import annotations

import numbers
import random
from typing import Sequence, Tuple

import numpy as np


class BaseTransform:
    def __call__(self, img):
        return self._apply_image(img)


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, img):
        for t in self.transforms:
            img = t(img)
        return img


def _size2(size) -> Tuple[int, int]:
    if isinstance(size, numbers.Number):
        return int(size), int(size)
    return int(size[0]), int(size[1])


def _resize_np(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Bilinear resize via separable linear interpolation (no PIL/cv2
    dependency in this environment)."""
    ih, iw = img.shape[:2]
    if (ih, iw) == (h, w):
        return img
    ys = np.linspace(0, ih - 1, h)
    xs = np.linspace(0, iw - 1, w)
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    y1 = np.minimum(y0 + 1, ih - 1)
    x1 = np.minimum(x0 + 1, iw - 1)
    wy = (ys - y0)[:, None]
    wx = (xs - x0)[None, :]
    im = img.astype(np.float32)
    if im.ndim == 2:
        im = im[:, :, None]
    top = im[y0][:, x0] * (1 - wx[..., None]) + im[y0][:, x1] * wx[..., None]
    bot = im[y1][:, x0] * (1 - wx[..., None]) + im[y1][:, x1] * wx[..., None]
    out = top * (1 - wy[..., None]) + bot * wy[..., None]
    if img.ndim == 2:
        out = out[:, :, 0]
    return out.astype(img.dtype) if img.dtype != np.uint8 else \
        np.clip(out, 0, 255).astype(np.uint8)


class Resize(BaseTransform):
    def __init__(self, size, interpolation="bilinear", keys=None):
        self.size = size

    def _apply_image(self, img):
        if isinstance(self.size, numbers.Number):
            # shorter side -> size, keep aspect
            h, w = img.shape[:2]
            if h < w:
                nh, nw = int(self.size), int(round(w * self.size / h))
            else:
                nh, nw = int(round(h * self.size / w)), int(self.size)
        else:
            nh, nw = _size2(self.size)
        return _resize_np(img, nh, nw)


class CenterCrop(BaseTransform):
    def __init__(self, size, keys=None):
        self.size = _size2(size)

    def _apply_image(self, img):
        h, w = img.shape[:2]
        th, tw = self.size
        i = max((h - th) // 2, 0)
        j = max((w - tw) // 2, 0)
        return img[i:i + th, j:j + tw]


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=None, pad_if_needed=False, keys=None):
        self.size = _size2(size)
        self.padding = padding

    def _apply_image(self, img):
        if self.padding:
            p = self.padding if isinstance(self.padding, (list, tuple)) \
                else (self.padding,) * 4
            pad = [(p[1], p[3]), (p[0], p[2])] + \
                  [(0, 0)] * (img.ndim - 2)
            img = np.pad(img, pad)
        h, w = img.shape[:2]
        th, tw = self.size
        i = random.randint(0, max(h - th, 0))
        j = random.randint(0, max(w - tw, 0))
        return img[i:i + th, j:j + tw]


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob: float = 0.5, keys=None):
        self.prob = prob

    def _apply_image(self, img):
        if random.random() < self.prob:
            return img[:, ::-1].copy()
        return img


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob: float = 0.5, keys=None):
        self.prob = prob

    def _apply_image(self, img):
        if random.random() < self.prob:
            return img[::-1].copy()
        return img


class Normalize(BaseTransform):
    """(img - mean) / std per channel; expects CHW float (after ToTensor)
    or HWC with data_format='HWC'."""

    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False,
                 keys=None):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.data_format = data_format

    def _apply_image(self, img):
        img = np.asarray(img, np.float32)
        if self.data_format == "CHW":
            m = self.mean.reshape(-1, 1, 1)
            s = self.std.reshape(-1, 1, 1)
        else:
            m, s = self.mean, self.std
        return (img - m) / s


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1), keys=None):
        self.order = order

    def _apply_image(self, img):
        if img.ndim == 2:
            img = img[:, :, None]
        return img.transpose(self.order)


class ToTensor(BaseTransform):
    """HWC uint8 [0,255] -> CHW float32 [0,1] numpy (collate device_puts)."""

    def __init__(self, data_format="CHW", keys=None):
        self.data_format = data_format

    def _apply_image(self, img):
        img = np.asarray(img)
        if img.ndim == 2:
            img = img[:, :, None]
        # scale by the ORIGINAL dtype, not the values: integer images are
        # always /255, float images are passed through (deciding by
        # img.max() would scale the same uint8 image differently
        # depending on its content)
        was_int = np.issubdtype(img.dtype, np.integer)
        img = img.astype(np.float32)
        if was_int:
            img = img / 255.0
        if self.data_format == "CHW":
            img = img.transpose(2, 0, 1)
        return img


class BrightnessTransform(BaseTransform):
    def __init__(self, value, keys=None):
        self.value = value

    def _apply_image(self, img):
        if self.value == 0:
            return img
        alpha = 1 + np.random.uniform(-self.value, self.value)
        dt = img.dtype
        out = np.clip(img.astype(np.float32) * alpha, 0,
                      255 if dt == np.uint8 else np.inf)
        return out.astype(dt)


class ColorJitter(BaseTransform):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0,
                 keys=None):
        self.brightness = BrightnessTransform(brightness)
        self._cfg = (contrast, saturation, hue)

    def _apply_image(self, img):
        img = self.brightness(img)
        contrast, saturation, hue = self._cfg
        order = np.random.permutation(3)
        for which in order:
            if which == 0 and contrast:
                img = ContrastTransform(contrast)(img)
            elif which == 1 and saturation:
                img = SaturationTransform(saturation)(img)
            elif which == 2 and hue:
                img = HueTransform(hue)(img)
        return img


def to_tensor(pic, data_format="CHW"):
    return ToTensor(data_format)(pic)


def resize(img, size, interpolation="bilinear"):
    return Resize(size, interpolation)(img)


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    return Normalize(mean, std, data_format)(img)


def hflip(img):
    return img[:, ::-1].copy()


def vflip(img):
    return img[::-1].copy()


def center_crop(img, output_size):
    return CenterCrop(output_size)(img)


def crop(img, top, left, height, width):
    return img[top:top + height, left:left + width]


# -- functional image ops (reference vision/transforms/functional.py) -------

def adjust_brightness(img, brightness_factor):
    dt = img.dtype
    hi = 255 if dt == np.uint8 else np.inf
    return np.clip(img.astype(np.float32) * brightness_factor, 0,
                   hi).astype(dt)


def adjust_contrast(img, contrast_factor):
    dt = img.dtype
    gray = _rgb_to_gray(img).mean()
    hi = 255 if dt == np.uint8 else np.inf
    out = gray + contrast_factor * (img.astype(np.float32) - gray)
    return np.clip(out, 0, hi).astype(dt)


def _rgb_to_gray(img):
    im = img.astype(np.float32)
    if im.ndim == 2 or im.shape[-1] == 1:
        return im.reshape(im.shape[:2])
    return im[..., 0] * 0.299 + im[..., 1] * 0.587 + im[..., 2] * 0.114


def adjust_saturation(img, saturation_factor):
    dt = img.dtype
    gray = _rgb_to_gray(img)[..., None]
    hi = 255 if dt == np.uint8 else np.inf
    out = gray + saturation_factor * (img.astype(np.float32) - gray)
    return np.clip(out, 0, hi).astype(dt)


def adjust_hue(img, hue_factor):
    """Shift hue by hue_factor (in [-0.5, 0.5]) via HSV round trip."""
    if not -0.5 <= hue_factor <= 0.5:
        raise ValueError("hue_factor must be in [-0.5, 0.5]")
    dt = img.dtype
    im = img.astype(np.float32) / (255.0 if dt == np.uint8 else 1.0)
    mx = im.max(-1)
    mn = im.min(-1)
    diff = mx - mn + 1e-12
    r, g, b = im[..., 0], im[..., 1], im[..., 2]
    h = np.where(mx == r, (g - b) / diff % 6,
                 np.where(mx == g, (b - r) / diff + 2, (r - g) / diff + 4))
    h = (h / 6.0 + hue_factor) % 1.0
    s = np.where(mx > 0, diff / (mx + 1e-12), 0)
    v = mx
    # hsv -> rgb
    i = np.floor(h * 6).astype(np.int64) % 6
    f = h * 6 - np.floor(h * 6)
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    choices = np.stack([
        np.stack([v, t, p], -1), np.stack([q, v, p], -1),
        np.stack([p, v, t], -1), np.stack([p, q, v], -1),
        np.stack([t, p, v], -1), np.stack([v, p, q], -1)], 0)
    out = np.take_along_axis(choices, i[None, ..., None], axis=0)[0]
    out = out * (255.0 if dt == np.uint8 else 1.0)
    return np.clip(out, 0, 255 if dt == np.uint8 else np.inf).astype(dt)


def to_grayscale(img, num_output_channels=1):
    g = _rgb_to_gray(img)
    out = np.repeat(g[..., None], num_output_channels, axis=-1)
    return out.astype(img.dtype) if img.dtype != np.uint8 else \
        np.clip(out, 0, 255).astype(np.uint8)


def pad(img, padding, fill=0, padding_mode="constant"):
    if isinstance(padding, numbers.Number):
        l = r = t = b = int(padding)
    elif len(padding) == 2:
        l, t = padding
        r, b = padding
    else:
        l, t, r, b = padding
    widths = [(t, b), (l, r)] + [(0, 0)] * (img.ndim - 2)
    if padding_mode == "constant":
        return np.pad(img, widths, constant_values=fill)
    return np.pad(img, widths, mode={"edge": "edge", "reflect": "reflect",
                                     "symmetric": "symmetric"}[padding_mode])


def erase(img, i, j, h, w, v, inplace=False):
    out = img if inplace else img.copy()
    chw = out.ndim == 3 and out.shape[0] in (1, 3) and out.shape[-1] not in (1, 3)
    if chw:
        out[:, i:i + h, j:j + w] = v
    else:
        out[i:i + h, j:j + w] = v
    return out


def _warp(img, minv, fill=0, out_size=None, interpolation="bilinear"):
    """Inverse-map warp with bilinear/nearest sampling; minv maps OUTPUT
    (x, y) homogeneous coords to INPUT coords. out_size=(oh, ow) sets the
    output canvas (defaults to the input's)."""
    ih, iw = img.shape[:2]
    oh, ow = out_size if out_size is not None else (ih, iw)
    ys, xs = np.mgrid[0:oh, 0:ow].astype(np.float32)
    ones = np.ones_like(xs)
    coords = np.stack([xs, ys, ones], 0).reshape(3, -1)
    src = minv @ coords
    sx = (src[0] / src[2]).reshape(oh, ow)
    sy = (src[1] / src[2]).reshape(oh, ow)
    if interpolation == "nearest":
        # floor(x+0.5), not np.round: banker's rounding combs half-pixel
        # coords (PIL/cv2 nearest round half up)
        sx, sy = np.floor(sx + 0.5), np.floor(sy + 0.5)
    elif interpolation != "bilinear":
        raise ValueError(
            f"unsupported interpolation {interpolation!r}: this build "
            "implements 'nearest' and 'bilinear'")
    x0 = np.floor(sx)
    y0 = np.floor(sy)
    lx, ly = sx - x0, sy - y0
    im = img.astype(np.float32)
    if im.ndim == 2:
        im = im[:, :, None]
    out = np.zeros((oh, ow, im.shape[2]), np.float32)
    for dy, wy in ((0, 1 - ly), (1, ly)):
        for dx, wx in ((0, 1 - lx), (1, lx)):
            xi = x0 + dx
            yi = y0 + dy
            ok = (xi >= 0) & (xi < iw) & (yi >= 0) & (yi < ih)
            xi = np.clip(xi, 0, iw - 1).astype(np.int64)
            yi = np.clip(yi, 0, ih - 1).astype(np.int64)
            w = (wy * wx * ok)[..., None]
            out += np.where(ok[..., None], im[yi, xi], fill) * w
    oob = (sx < -0.5) | (sx > iw - 0.5) | (sy < -0.5) | (sy > ih - 0.5)
    out[oob] = fill
    if img.ndim == 2:
        out = out[..., 0]
    return out.astype(img.dtype) if img.dtype != np.uint8 else \
        np.clip(out, 0, 255).astype(np.uint8)


def _affine_fwd_matrix(angle, translate, scale, shear, center):
    """Forward map for a CLOCKWISE ``angle`` (the affine() convention;
    reference functional.py:642)."""
    a = np.deg2rad(angle)
    sx, sy = np.deg2rad(shear[0]), np.deg2rad(shear[1])
    cx, cy = center
    tx, ty = translate
    # forward: T(center) R S Sh T(-center) + translate
    rot = np.asarray([[np.cos(a + sy), -np.sin(a + sx), 0],
                      [np.sin(a + sy), np.cos(a + sx), 0],
                      [0, 0, 1]], np.float64)
    sc = np.diag([scale, scale, 1.0])
    to_c = np.asarray([[1, 0, cx], [0, 1, cy], [0, 0, 1]], np.float64)
    from_c = np.asarray([[1, 0, -cx], [0, 1, -cy], [0, 0, 1]], np.float64)
    tr = np.asarray([[1, 0, tx], [0, 1, ty], [0, 0, 1]], np.float64)
    return tr @ to_c @ rot @ sc @ from_c


def affine(img, angle=0.0, translate=(0, 0), scale=1.0, shear=(0.0, 0.0),
           interpolation="bilinear", fill=0, center=None):
    h, w = img.shape[:2]
    center = center or ((w - 1) / 2.0, (h - 1) / 2.0)
    shear = shear if isinstance(shear, (list, tuple)) else (shear, 0.0)
    fwd = _affine_fwd_matrix(angle, translate, scale, shear, center)
    return _warp(img, np.linalg.inv(fwd), fill,
                 interpolation=interpolation)


def rotate(img, angle, interpolation="nearest", expand=False, center=None,
           fill=0):
    # angle is COUNTER-clockwise (reference functional.py:778), the
    # opposite of affine()'s clockwise convention
    h, w = img.shape[:2]
    center = center or ((w - 1) / 2.0, (h - 1) / 2.0)
    fwd = _affine_fwd_matrix(-angle, (0, 0), 1.0, (0.0, 0.0), center)
    if not expand:
        return _warp(img, np.linalg.inv(fwd), fill,
                     interpolation=interpolation)
    # expand: canvas grows to the rotated image's bounding box
    corners = np.asarray([[0, 0, 1], [w - 1, 0, 1],
                          [0, h - 1, 1], [w - 1, h - 1, 1]], np.float64).T
    mapped = fwd @ corners
    cx, cy = mapped[0] / mapped[2], mapped[1] / mapped[2]
    ow = int(np.ceil(cx.max() - cx.min())) + 1
    oh = int(np.ceil(cy.max() - cy.min())) + 1
    shift = np.asarray([[1, 0, cx.min()], [0, 1, cy.min()], [0, 0, 1]],
                       np.float64)
    return _warp(img, np.linalg.inv(fwd) @ shift, fill, out_size=(oh, ow),
                 interpolation=interpolation)


def perspective(img, startpoints, endpoints, interpolation="bilinear",
                fill=0):
    """Warp mapping startpoints -> endpoints (4 corner pairs)."""
    A = []
    for (sx, sy), (ex, ey) in zip(startpoints, endpoints):
        A.append([sx, sy, 1, 0, 0, 0, -ex * sx, -ex * sy])
        A.append([0, 0, 0, sx, sy, 1, -ey * sx, -ey * sy])
    b = np.asarray([c for pt in endpoints for c in pt], np.float64)
    coef = np.linalg.lstsq(np.asarray(A, np.float64), b, rcond=None)[0]
    fwd = np.append(coef, 1.0).reshape(3, 3)
    return _warp(img, np.linalg.inv(fwd), fill, interpolation=interpolation)


# -- class transforms -------------------------------------------------------

class ContrastTransform(BaseTransform):
    def __init__(self, value, keys=None):
        self.value = value

    def _apply_image(self, img):
        if self.value == 0:
            return img
        return adjust_contrast(img,
                               1 + np.random.uniform(-self.value, self.value))


class SaturationTransform(BaseTransform):
    def __init__(self, value, keys=None):
        self.value = value

    def _apply_image(self, img):
        if self.value == 0:
            return img
        return adjust_saturation(
            img, 1 + np.random.uniform(-self.value, self.value))


class HueTransform(BaseTransform):
    def __init__(self, value, keys=None):
        self.value = value

    def _apply_image(self, img):
        if self.value == 0:
            return img
        return adjust_hue(img, np.random.uniform(-self.value, self.value))


class Pad(BaseTransform):
    def __init__(self, padding, fill=0, padding_mode="constant", keys=None):
        self.args = (padding, fill, padding_mode)

    def _apply_image(self, img):
        return pad(img, *self.args)


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels=1, keys=None):
        self.n = num_output_channels

    def _apply_image(self, img):
        return to_grayscale(img, self.n)


class RandomRotation(BaseTransform):
    def __init__(self, degrees, interpolation="nearest", expand=False,
                 center=None, fill=0, keys=None):
        self.degrees = (degrees if isinstance(degrees, (list, tuple))
                        else (-degrees, degrees))
        self.interpolation = interpolation
        self.expand = expand
        self.center = center
        self.fill = fill

    def _apply_image(self, img):
        angle = np.random.uniform(*self.degrees)
        return rotate(img, angle, interpolation=self.interpolation,
                      expand=self.expand, center=self.center,
                      fill=self.fill)


class RandomAffine(BaseTransform):
    def __init__(self, degrees, translate=None, scale=None, shear=None,
                 interpolation="nearest", fill=0, center=None, keys=None):
        self.degrees = (degrees if isinstance(degrees, (list, tuple))
                        else (-degrees, degrees))
        self.translate = translate
        self.scale = scale
        if shear is not None and not isinstance(shear, (list, tuple)):
            shear = (-shear, shear)
        if shear is not None and len(shear) not in (2, 4):
            raise ValueError("shear must be a number or a 2- or 4-element "
                             f"sequence, got {shear!r}")
        self.shear = shear  # 2 elems: x-range; 4: x-range + y-range
        self.interpolation = interpolation
        self.fill = fill
        self.center = center

    def _apply_image(self, img):
        h, w = img.shape[:2]
        angle = np.random.uniform(*self.degrees)
        tx = ty = 0.0
        if self.translate:
            tx = np.random.uniform(-self.translate[0], self.translate[0]) * w
            ty = np.random.uniform(-self.translate[1], self.translate[1]) * h
        sc = (np.random.uniform(*self.scale) if self.scale else 1.0)
        sh_x = sh_y = 0.0
        if self.shear is not None:
            sh_x = np.random.uniform(self.shear[0], self.shear[1])
            if len(self.shear) == 4:
                sh_y = np.random.uniform(self.shear[2], self.shear[3])
        return affine(img, angle=angle, translate=(tx, ty), scale=sc,
                      shear=(sh_x, sh_y), interpolation=self.interpolation,
                      fill=self.fill, center=self.center)


class RandomPerspective(BaseTransform):
    def __init__(self, prob=0.5, distortion_scale=0.5,
                 interpolation="bilinear", fill=0, keys=None):
        self.prob = prob
        self.scale = distortion_scale
        self.interpolation = interpolation
        self.fill = fill

    def _apply_image(self, img):
        if np.random.rand() >= self.prob:
            return img
        h, w = img.shape[:2]
        d = self.scale
        tl = (np.random.uniform(0, d * w / 2), np.random.uniform(0, d * h / 2))
        tr = (w - 1 - np.random.uniform(0, d * w / 2),
              np.random.uniform(0, d * h / 2))
        br = (w - 1 - np.random.uniform(0, d * w / 2),
              h - 1 - np.random.uniform(0, d * h / 2))
        bl = (np.random.uniform(0, d * w / 2),
              h - 1 - np.random.uniform(0, d * h / 2))
        start = [(0, 0), (w - 1, 0), (w - 1, h - 1), (0, h - 1)]
        return perspective(img, start, [tl, tr, br, bl],
                           interpolation=self.interpolation, fill=self.fill)


class RandomResizedCrop(BaseTransform):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3. / 4, 4. / 3),
                 interpolation="bilinear", keys=None):
        self.size = _size2(size)
        self.scale = scale
        self.ratio = ratio

    def _apply_image(self, img):
        h, w = img.shape[:2]
        area = h * w
        for _ in range(10):
            target = area * np.random.uniform(*self.scale)
            ar = np.exp(np.random.uniform(np.log(self.ratio[0]),
                                          np.log(self.ratio[1])))
            cw = int(round(np.sqrt(target * ar)))
            ch = int(round(np.sqrt(target / ar)))
            if 0 < cw <= w and 0 < ch <= h:
                top = np.random.randint(0, h - ch + 1)
                left = np.random.randint(0, w - cw + 1)
                patch = img[top:top + ch, left:left + cw]
                return _resize_np(patch, *self.size)
        side = min(h, w)  # fallback: center crop
        top, left = (h - side) // 2, (w - side) // 2
        return _resize_np(img[top:top + side, left:left + side], *self.size)


class RandomErasing(BaseTransform):
    def __init__(self, prob=0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3),
                 value=0, inplace=False, keys=None):
        self.prob = prob
        self.scale = scale
        self.ratio = ratio
        self.value = value

    def _apply_image(self, img):
        if np.random.rand() >= self.prob:
            return img
        h, w = (img.shape[1:3] if img.ndim == 3 and img.shape[0] in (1, 3)
                and img.shape[-1] not in (1, 3) else img.shape[:2])
        area = h * w
        for _ in range(10):
            target = area * np.random.uniform(*self.scale)
            ar = np.random.uniform(*self.ratio)
            eh = int(round(np.sqrt(target / ar)))
            ew = int(round(np.sqrt(target * ar)))
            if eh < h and ew < w:
                i = np.random.randint(0, h - eh)
                j = np.random.randint(0, w - ew)
                return erase(img, i, j, eh, ew, self.value)
        return img
