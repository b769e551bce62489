"""The port's ``hapi.Model`` against the JAX package's.

LeNet with the JAX model's weights (``vision.models.params_from_jax``)
goes through ``prepare`` / ``fit`` / ``evaluate`` / ``predict`` in both
packages on the same ``FakeData`` (B 8, ``shuffle=False``, 4 batches),
with Adam and with Momentum, ``CrossEntropyLoss`` and ``Accuracy(topk=(1,
2))``: the per-batch losses (recorded by a callback on each side), the
weights after ``fit``, the ``evaluate`` logs and the ``predict`` outputs
agree within f32 ``rtol 1e-5`` / ``atol 1e-6`` (the two libraries'
convolutions and reductions sum in other orders), except Adam's
weights, held within ``atol`` 1 % of its learning rate (1e-5): Adam's
update ``lr · m̂ / (√v̂ + ε)`` is near ``±lr`` for any gradient above ε,
so an element whose gradient is a few ε moves by a visible part of
``lr`` for a rounding difference in that gradient (4.2e-6 measured on
one of LeNet's 61,706 weights). The same holds with
``accumulate_grad_batches=2`` and for a scheduled fit, which the JAX
package runs with an explicit callback that steps the same scheduler
(its own ``LRScheduler`` callback steps nothing). ``EarlyStopping``
stops both at the same epoch; ``ModelCheckpoint`` writes the same files;
``summary`` counts the same totals. A ``.pdparams`` written by the JAX
package's ``save`` reads in the port, and the reverse; ``Model.save`` /
``load`` restore the weights, the optimizer's slots and its scheduler
bitwise.
"""
import os

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (a worker's share of the cores)

import paddle_tpu as pt
from paddle_tpu import hapi as JH
from paddle_tpu.metric import Accuracy as JAccuracy
from paddle_tpu.vision.datasets import FakeData as JFake
import paddle_tpu_torch as P
from paddle_tpu_torch import hapi as TH
from paddle_tpu_torch import nn as TNN
from paddle_tpu_torch import optimizer as TO
from paddle_tpu_torch.framework import io as TFIO
from paddle_tpu_torch.metric import Accuracy as TAccuracy
from paddle_tpu_torch.optimizer import lr as TLR
from paddle_tpu_torch.vision import models as TM
from paddle_tpu_torch.vision.datasets import FakeData as TFake

RTOL, ATOL = 1e-5, 1e-6
ADAM_WEIGHT_ATOL = 1e-5   # 1 % of Adam's lr (module docstring)
B, N_TRAIN, N_TEST = 8, 32, 16
FAKE = dict(image_shape=(1, 28, 28), num_classes=10)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=RTOL,
                               atol=ATOL)


def _nets(seed=0):
    pt.seed(seed)
    jnet = pt.vision.models.LeNet()
    state = {k: np.array(v._data) for k, v in jnet.state_dict().items()}
    tnet = TM.LeNet(device="cpu")
    tnet.load_state_dict(TM.params_from_jax(state, device="cpu"))
    return jnet, tnet


def _jstate(jnet):
    return {k: np.asarray(v._data) for k, v in jnet.state_dict().items()}


def _tstate(tnet):
    return {k: v.detach().numpy() for k, v in tnet.state_dict().items()}


def _data(mod_fake):
    return (mod_fake(num_samples=N_TRAIN, seed=0, **FAKE),
            mod_fake(num_samples=N_TEST, seed=1, **FAKE))


def _recorder(base):
    class Losses(base):
        def __init__(self):
            super().__init__()
            self.losses, self.lrs, self.epochs = [], [], 0

        def on_epoch_begin(self, epoch, logs=None):
            self.epochs += 1

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs["loss"])
            self.lrs.append(float(np.asarray(
                self.model._optimizer._lr.numpy())))
    return Losses()


class JStepScheduler(JH.LRScheduler):
    """The JAX ``LRScheduler`` callback aimed at the optimizer's
    scheduler: what the port's callback does."""

    def _sched(self):
        return self.model._optimizer._lr_sched


def _opt(pkg, kind, params):
    if kind == "adam":
        return pkg.optimizer.Adam(learning_rate=1e-3, parameters=params)
    lr = 0.01
    if kind == "scheduled":
        lr = (pt.optimizer.lr if pkg is pt else TLR).StepDecay(
            0.02, step_size=1, gamma=0.5)
    return pkg.optimizer.Momentum(learning_rate=lr, momentum=0.9,
                                  parameters=params)


def _fit_both(kind, **fit_kw):
    jnet, tnet = _nets()
    jtrain, jtest = _data(JFake)
    ttrain, ttest = _data(TFake)
    jm = JH.Model(jnet).prepare(_opt(pt, kind, jnet.parameters()),
                                pt.nn.CrossEntropyLoss(),
                                JAccuracy(topk=(1, 2)))
    tm = TH.Model(tnet).prepare(_opt(P, kind, tnet.parameters()),
                                TNN.CrossEntropyLoss(),
                                TAccuracy(topk=(1, 2)))
    jrec, trec = _recorder(JH.Callback), _recorder(TH.Callback)
    jcb, tcb = [jrec], [trec]
    if kind == "scheduled":
        jcb.append(JStepScheduler(by_step=True, by_epoch=False))
        tcb.append(TH.LRScheduler(by_step=True, by_epoch=False))
    kw = dict(batch_size=B, shuffle=False, verbose=0, **fit_kw)
    jm.fit(jtrain, callbacks=jcb, **kw)
    tm.fit(ttrain, callbacks=tcb, **kw)
    return dict(jm=jm, tm=tm, jrec=jrec, trec=trec, jtest=jtest,
                ttest=ttest)


@pytest.fixture(scope="module", params=["adam", "momentum"])
def fitted(request):
    return _fit_both(request.param)


def test_fit_losses_and_weights_match_jax(fitted):
    trec, jrec = fitted["trec"], fitted["jrec"]
    assert len(trec.losses) == len(jrec.losses) == N_TRAIN // B
    assert all(isinstance(v, float) for v in trec.losses)
    _close(trec.losses, jrec.losses)
    js, ts = _jstate(fitted["jm"].network), _tstate(fitted["tm"].network)
    assert sorted(js) == sorted(ts)
    adam = isinstance(fitted["tm"]._optimizer, TO.Adam)
    for k in js:
        if adam:
            np.testing.assert_allclose(ts[k], js[k], rtol=RTOL,
                                       atol=ADAM_WEIGHT_ATOL)
        else:
            _close(ts[k], js[k])
    assert fitted["tm"]._optimizer._step_count == N_TRAIN // B


def test_evaluate_logs_match_jax(fitted):
    jl = fitted["jm"].evaluate(fitted["jtest"], batch_size=B, verbose=0)
    tl = fitted["tm"].evaluate(fitted["ttest"], batch_size=B, verbose=0)
    assert sorted(tl) == sorted(jl) == ["acc_top1", "acc_top2", "loss"]
    for k in jl:
        _close(tl[k], jl[k])


def test_predict_outputs_match_jax(fitted):
    jp = fitted["jm"].predict(fitted["jtest"], batch_size=B,
                              stack_outputs=True)
    tp = fitted["tm"].predict(fitted["ttest"], batch_size=B,
                              stack_outputs=True)
    assert tp[0].shape == jp[0].shape == (N_TEST, 10)
    assert isinstance(tp[0], np.ndarray)
    _close(tp[0], jp[0])
    per_batch = fitted["tm"].predict(fitted["ttest"], batch_size=B)
    assert len(per_batch) == N_TEST // B


def test_save_load_round_trip(fitted, tmp_path):
    tm = fitted["tm"]
    path = str(tmp_path / "ckpt" / "m")
    tm.save(path)
    assert os.path.exists(path + ".pdparams")
    assert os.path.exists(path + ".pdopt")
    _, tnet2 = _nets(seed=3)
    kind = "adam" if isinstance(tm._optimizer, TO.Adam) else "momentum"
    tm2 = TH.Model(tnet2).prepare(_opt(P, kind, tnet2.parameters()),
                                  TNN.CrossEntropyLoss())
    tm2.load(path)
    for k, v in tm.network.state_dict().items():
        assert torch.equal(tnet2.state_dict()[k], v)
    a, b = tm._optimizer, tm2._optimizer
    assert b._step_count == a._step_count
    for slot, store in a._accumulators.items():
        for p, p2 in zip(a._param_list, b._param_list):
            assert torch.equal(b._accumulators[slot][id(p2)], store[id(p)])
    np.testing.assert_array_equal(
        tm2.predict(fitted["ttest"], batch_size=B, stack_outputs=True)[0],
        tm.predict(fitted["ttest"], batch_size=B, stack_outputs=True)[0])


def test_accumulate_grad_batches_matches_jax():
    r = _fit_both("momentum", accumulate_grad_batches=2)
    _close(r["trec"].losses, r["jrec"].losses)
    assert r["tm"]._optimizer._step_count == N_TRAIN // B // 2
    js, ts = _jstate(r["jm"].network), _tstate(r["tm"].network)
    for k in js:
        _close(ts[k], js[k])


def test_scheduled_fit_matches_jax_with_a_stepping_callback():
    r = _fit_both("scheduled")
    assert r["trec"].lrs == r["jrec"].lrs
    np.testing.assert_allclose(r["trec"].lrs,
                               [0.02 * 0.5 ** i for i in range(4)],
                               rtol=1e-7)
    _close(r["trec"].losses, r["jrec"].losses)
    js, ts = _jstate(r["jm"].network), _tstate(r["tm"].network)
    for k in js:
        _close(ts[k], js[k])


def test_default_callback_steps_the_scheduler_each_epoch():
    _, tnet = _nets()
    sched = TLR.StepDecay(0.02, step_size=1, gamma=0.5)
    tm = TH.Model(tnet).prepare(
        TO.Momentum(learning_rate=sched, parameters=tnet.parameters()),
        TNN.CrossEntropyLoss())
    tm.fit(_data(TFake)[0], batch_size=B, epochs=2, verbose=0,
           num_iters=6)
    assert sched.last_epoch == 2


def test_early_stopping_and_checkpoints_match_jax(tmp_path):
    """``EarlyStopping`` on an accuracy that never reaches its baseline
    stops after ``patience`` evaluations in both packages;
    ``ModelCheckpoint`` writes the same files."""
    jnet, tnet = _nets()
    jtrain, jtest = _data(JFake)
    ttrain, ttest = _data(TFake)
    out = {}
    for name, pkg, hapi, net, train, test, acc in (
            ("jax", pt, JH, jnet, jtrain, jtest, JAccuracy),
            ("port", P, TH, tnet, ttrain, ttest, TAccuracy)):
        m = hapi.Model(net).prepare(_opt(pkg, "momentum", net.parameters()),
                                    pkg.nn.CrossEntropyLoss(), acc())
        rec = _recorder(hapi.Callback)
        d = tmp_path / name
        m.fit(train, eval_data=test, batch_size=B, epochs=5, verbose=0,
              shuffle=False, save_dir=str(d),
              callbacks=[rec, hapi.EarlyStopping(
                  monitor="acc", mode="max", patience=2, baseline=1.1)])
        out[name] = (rec.epochs, sorted(os.listdir(d)), m)
    assert out["port"][0] == out["jax"][0] == 2
    assert out["port"][1] == out["jax"][1]
    assert "final.pdparams" in out["port"][1]
    fresh = TH.Model(_nets(seed=5)[1])
    fresh.load(str(tmp_path / "port" / "final"), reset_optimizer=True)
    for k, v in out["port"][2].network.state_dict().items():
        assert torch.equal(fresh.network.state_dict()[k], v)


def test_summary_totals_match_jax(capsys):
    jnet, tnet = _nets()
    assert TH.summary(tnet) == JH.summary(jnet)
    assert TH.Model(tnet).summary()["total_params"] == sum(
        p.numel() for p in tnet.parameters())
    tnet.features[0].weight.requires_grad_(False)
    s = TH.summary(tnet)
    assert s["trainable_params"] == s["total_params"] - 54
    capsys.readouterr()


def test_pdparams_read_across_packages(tmp_path):
    jnet, tnet = _nets(seed=1)
    jpath = str(tmp_path / "jax.pdparams")
    pt.save(jnet.state_dict(), jpath)
    _, other = _nets(seed=2)
    other.load_state_dict(TFIO.load(jpath, device="cpu"))
    for k, v in _jstate(jnet).items():
        np.testing.assert_array_equal(other.state_dict()[k].numpy(), v)
    loaded = TFIO.load(jpath, device="cpu")
    assert all(isinstance(loaded[k], torch.nn.Parameter)
               for k, _ in tnet.named_parameters())
    assert TFIO.load(jpath, return_numpy=True)["fc.0.weight"].dtype == \
        np.float32

    tpath = str(tmp_path / "port.pdparams")
    P.save(tnet.state_dict(keep_vars=True), tpath)
    jother = _nets(seed=2)[0]
    jother.set_state_dict(pt.load(tpath))
    for k, v in _tstate(tnet).items():
        np.testing.assert_array_equal(_jstate(jother)[k], v)


def test_bf16_round_trip_and_tags(tmp_path):
    t = {"w": torch.randn(3, 5).bfloat16().requires_grad_(),
         "n": 4, "nested": [torch.arange(6, dtype=torch.int64)]}
    path = str(tmp_path / "x.pdopt")
    P.save(t, path)
    back = P.load(path, device="cpu")
    assert back["w"].dtype == torch.bfloat16 and back["w"].requires_grad
    assert torch.equal(back["w"], t["w"]) and back["n"] == 4
    assert torch.equal(back["nested"][0], t["nested"][0])
    assert not back["nested"][0].requires_grad
    wide = P.load(path, return_numpy=True)["w"]
    np.testing.assert_array_equal(wide, t["w"].float().detach().numpy())


def test_prepare_refuses_amp_configs_and_the_cpu_unless_asked():
    tnet = _nets()[1]
    with pytest.raises(NotImplementedError, match="amp_configs"):
        TH.Model(tnet).prepare(amp_configs={"level": "O1"})
    assert P.Model is TH.Model
    if torch.cuda.is_available():
        pytest.skip("CUDA is present here: the default device is the card")
    with pytest.raises(RuntimeError, match="CUDA"):
        P.load(str(os.devnull))
    with pytest.raises(RuntimeError, match="CUDA"):
        TH.Model(torch.nn.ReLU()).predict([np.zeros((2, 3), np.float32)])
