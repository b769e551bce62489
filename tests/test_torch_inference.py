"""The port's inference front end vs the JAX package's: ``Config`` /
``create_predictor`` / ``Predictor`` over ``jit.save``'d programs,
``DynamicBatcher`` (both modes), ``get_version``, and the parameter-level
passes ``fold_batch_norms`` / ``remove_dropouts`` / ``fuse_linear_chains``
with the dataflow trace they stand on (``core.graph_trace``).

Each case runs the JAX function and the port's on the same numpy inputs
made from a seed, the port's weights carried over from the JAX model's
``state_dict`` (``params_from_jax``). Contract (f32): predictor outputs
within the JAX tests' rtol = atol = 1e-5 of the JAX predictor's; a
folded model's output within the JAX fold test's rtol 2e-4 / atol 2e-5
of the unfolded one, on both sides, and of the JAX folded model's; fold,
dropout and fuse counts equal to JAX's on every case of
``tests/test_inference.py``; the consumer counts of the trace equal
JAX's; batcher rows and greedy tokens equal to the JAX batcher's.
"""
import threading

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (a worker's share of the cores)
from torch import nn

import jax
import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu import inference as JI
from paddle_tpu.core.graph_trace import trace_layer_graph as j_trace
from paddle_tpu.inference.serving import DynamicBatcher as JBatcher
from paddle_tpu.jit import InputSpec as JSpec
from paddle_tpu.models import llama as JL
from paddle_tpu.vision import models as JM
from paddle_tpu_torch import inference as TI
from paddle_tpu_torch import jit as TJ
from paddle_tpu_torch.analysis import fold_conv_bn
from paddle_tpu_torch.core.graph_trace import trace_layer_graph as t_trace
from paddle_tpu_torch.inference.serving import DynamicBatcher as TBatcher
from paddle_tpu_torch.models import _layers
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.vision import models as TM

RTOL = ATOL = 1e-5
FOLD_RTOL, FOLD_ATOL = 2e-4, 2e-5


def _state(jmodel) -> dict:
    return {k: np.array(v._data) for k, v in jmodel.state_dict().items()}


def _port(jmodel, factory, **kw):
    port = getattr(TM, factory)(device="cpu", **kw)
    port.load_state_dict(TM.params_from_jax(_state(jmodel), device="cpu"))
    return port.eval()


def _seed_bn(jmodel, rs):
    """Non-trivial BN statistics and affine on the JAX model."""
    for layer in jmodel.sublayers():
        if isinstance(layer, pt.nn.BatchNorm2D):
            c = layer.num_features
            layer._mean._data = jnp.asarray(0.1 * rs.randn(c), jnp.float32)
            layer._variance._data = jnp.asarray(rs.uniform(0.5, 1.5, c),
                                                jnp.float32)
            layer.weight._data = jnp.asarray(1 + 0.1 * rs.randn(c),
                                             jnp.float32)
            layer.bias._data = jnp.asarray(0.1 * rs.randn(c), jnp.float32)


def _jax_predictor(jmodel, path, shape):
    pt.jit.save(jmodel, path, input_spec=[JSpec(shape, "float32")])
    return JI.create_predictor(JI.Config(path))


def _port_predictor(model, path, shape):
    TJ.save(model, path, input_spec=[TJ.InputSpec(shape, "float32")])
    cfg = TI.Config(path)
    cfg.disable_gpu()
    return TI.create_predictor(cfg)


# --------------------------------------------------------------------------
# Config / create_predictor / Predictor
# --------------------------------------------------------------------------

# name: (factory, kwargs, input shape [C, H, W])
MODELS = {"lenet": ("LeNet", {}, [1, 28, 28]),
          "resnet18": ("resnet18", {"num_classes": 7}, [3, 32, 32])}


@pytest.fixture(scope="module", params=sorted(MODELS))
def pair(request, tmp_path_factory):
    """The JAX and port predictors of one model from one state, both
    saved with a dynamic batch, and the port's eager model."""
    factory, kw, chw = MODELS[request.param]
    pt.seed(0)
    jm = getattr(JM, factory)(**kw)
    _seed_bn(jm, np.random.RandomState(1))
    jm.eval()
    port = _port(jm, factory, **kw)
    d = tmp_path_factory.mktemp(request.param)
    shape = [None] + chw
    return dict(name=request.param, chw=chw, jm=jm, port=port,
                jpred=_jax_predictor(jm, str(d / "jax"), shape),
                tpred=_port_predictor(port, str(d / "port"), shape),
                dir=d)


@pytest.mark.parametrize("B", [1, 3])
def test_predictor_matches_jax_predictor(pair, B):
    x = np.random.RandomState(B).randn(B, *pair["chw"]).astype(np.float32)
    want = pair["jpred"].run([x])
    got = pair["tpred"].run([x])
    assert len(got) == len(want) == 1
    assert got[0].dtype == np.float32 and got[0].shape == want[0].shape
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=ATOL)
    with torch.no_grad():
        eager = pair["port"](torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got[0], eager)


def test_predictor_named_handles_match_jax(pair):
    x = np.random.RandomState(5).randn(2, *pair["chw"]).astype(np.float32)
    outs = []
    for pred in (pair["jpred"], pair["tpred"]):
        names = pred.get_input_names()
        assert names == ["input_0"]
        h = pred.get_input_handle(names[0])
        h.copy_from_cpu(x)
        assert h.shape() == list(x.shape)
        pred.run()
        assert pred.get_output_names() == ["output_0"]
        outs.append(pred.get_output_handle("output_0").copy_to_cpu())
    np.testing.assert_allclose(outs[1], outs[0], rtol=RTOL, atol=ATOL)
    # __call__ is run
    np.testing.assert_array_equal(pair["tpred"](x)[0], outs[1])


def test_folded_program_is_the_folded_model(pair):
    """The conv-bn fold (``analysis.fold_conv_bn``) saved and served: the
    predictor gives the folded eager model's bits, within the fold's
    tolerance of the JAX predictor; the program holds one operator node
    per kernel-route site."""
    from paddle_tpu_torch.analysis import site_routes
    folded, _ = fold_conv_bn(pair["port"])
    pred = _port_predictor(folded, str(pair["dir"] / "folded"),
                           [None] + pair["chw"])
    nodes = [n for n in pred.program.program.graph.nodes
             if "matmul_bias_act" in str(n.target)]
    assert len(nodes) == site_routes(folded).get("kernel", 0)
    x = np.random.RandomState(7).randn(3, *pair["chw"]).astype(np.float32)
    got = pred.run([x])[0]
    with torch.no_grad():
        np.testing.assert_array_equal(got, folded(torch.from_numpy(x))
                                      .numpy())
    want = pair["jpred"].run([x])[0]
    np.testing.assert_allclose(got, want, rtol=FOLD_RTOL, atol=FOLD_ATOL)


def test_config_surface_matches_jax(tmp_path):
    path = str(tmp_path / "m")
    for mod in (JI, TI):
        cfg = mod.Config(path)
        assert cfg.model_dir() == path
        cfg.set_model(path + "2")
        assert cfg.model_dir() == path + "2"
        cfg.enable_memory_optim()
        cfg.switch_ir_optim(True)
        with pytest.raises(NotImplementedError):
            cfg.enable_tensorrt_engine()
        with pytest.raises(ValueError, match="set_model"):
            mod.create_predictor(mod.Config())
    cfg = TI.Config(path)
    assert cfg._device == "cuda"
    cfg.enable_use_gpu(256, 1)
    assert cfg._device == "cuda:1"
    cfg.disable_gpu()
    assert cfg._device == "cpu"
    n = torch.get_num_threads()
    try:
        cfg.set_cpu_math_library_num_threads(2)
        assert torch.get_num_threads() == 2
    finally:
        torch.set_num_threads(n)
    assert TI.get_version() == JI.get_version() == "0.3.0"
    assert TI.PlaceType.GPU == JI.PlaceType.GPU == "gpu"


def test_config_without_cuda_raises(pair):
    """A Config that names no device asks for the card; without CUDA
    building the predictor raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present here: the default device is the card")
    path = str(pair["dir"] / "port")
    with pytest.raises(RuntimeError, match="CUDA"):
        TI.create_predictor(TI.Config(path))
    cfg = TI.Config(path + ".pdmodel")
    cfg.enable_use_gpu(100, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        TI.create_predictor(cfg)


def test_predictor_casts_to_the_spec_dtype(tmp_path):
    """A bfloat16 program takes float32 numpy (rounded once) and returns
    float32 numpy holding its bfloat16 outputs exactly."""
    torch.manual_seed(0)
    model = nn.Sequential(nn.Linear(6, 4)).to(torch.bfloat16)
    TJ.save(model, str(tmp_path / "bf"),
            input_spec=[TJ.InputSpec([None, 6], "bfloat16")])
    cfg = TI.Config(str(tmp_path / "bf"))
    cfg.disable_gpu()
    pred = TI.create_predictor(cfg)
    x = np.random.RandomState(0).randn(3, 6).astype(np.float32)
    got = pred.run([x])[0]
    with torch.no_grad():
        want = model(torch.from_numpy(x).bfloat16()).float().numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------
# DynamicBatcher (tests/test_inference.py:57-121)
# --------------------------------------------------------------------------

def _submit_all(batcher, xs):
    futs = [None] * len(xs)

    def put(i):
        futs[i] = batcher.submit(xs[i])

    threads = [threading.Thread(target=put, args=(i,))
               for i in range(len(xs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return [f.result(timeout=60) for f in futs]


def test_dynamic_batcher_coalesces_and_matches_jax():
    w = np.random.RandomState(0).randn(8, 4).astype(np.float32)
    xs = [np.random.RandomState(i).randn(8).astype(np.float32)
          for i in range(12)]
    jfn = jax.jit(lambda x: x @ jnp.asarray(w))
    tw = torch.from_numpy(w)
    with JBatcher(jfn, max_batch_size=8, max_delay_ms=30) as jb:
        want = _submit_all(jb, xs)
    with TBatcher(lambda x: torch.from_numpy(x) @ tw, max_batch_size=8,
                  max_delay_ms=30) as tb:
        got = _submit_all(tb, xs)
        stats = dict(tb.stats)
    for g, jv, x in zip(got, want, xs):
        assert isinstance(g, np.ndarray) and g.dtype == np.float32
        np.testing.assert_allclose(g, np.asarray(jv), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(g, x @ w, rtol=RTOL, atol=ATOL)
    assert stats["requests"] == 12
    assert stats["batches"] < 12, stats  # some coalescing happened


def test_dynamic_batcher_shape_isolation_and_padding_match_jax():
    runs = {}
    for name, cls in (("jax", JBatcher), ("port", TBatcher)):
        calls = []

        def fn(x, calls=calls):
            calls.append(x.shape)
            return x * 2

        with cls(fn, max_batch_size=4, max_delay_ms=0) as b:
            r1 = b.infer(np.ones((3,), np.float32))
            r2 = b.infer(np.ones((5,), np.float32))
            stats = dict(b.stats)
        np.testing.assert_array_equal(r1, np.full((3,), 2, np.float32))
        np.testing.assert_array_equal(r2, np.full((5,), 2, np.float32))
        assert all(s[0] in (1, 2, 4) for s in calls), calls
        assert {s[1:] for s in calls} == {(3,), (5,)}
        runs[name] = (calls, stats)
    assert runs["port"] == runs["jax"]


def test_dynamic_batcher_tuple_outputs_and_errors_match_jax():
    for cls, wrap in ((JBatcher, np.asarray), (TBatcher, torch.from_numpy)):
        def fn(x, wrap=wrap):
            if np.isnan(x).any():
                raise ValueError("nan batch")
            t = wrap(x)
            return t + 1, t.sum(axis=tuple(range(1, x.ndim)))

        with cls(fn, max_batch_size=2, max_delay_ms=0) as b:
            row, s = b.infer(np.ones((2, 2), np.float32))
            np.testing.assert_array_equal(row,
                                          np.full((2, 2), 2, np.float32))
            assert float(s) == 4.0
            f = b.submit(np.full((2, 2), np.nan, np.float32))
            with pytest.raises(ValueError, match="nan batch"):
                f.result()
        with pytest.raises(RuntimeError, match="closed"):
            b.submit(np.ones((2, 2), np.float32))


def test_dynamic_batcher_bfloat16_rows_come_back_as_float32():
    with TBatcher(lambda x: torch.from_numpy(x).bfloat16() * 3,
                  max_batch_size=4, max_delay_ms=0) as b:
        row = b.infer(np.asarray([1.0, 1.0 / 3], np.float32))
    want = (torch.tensor([1.0, 1.0 / 3]).bfloat16() * 3).float().numpy()
    assert row.dtype == np.float32
    np.testing.assert_array_equal(row, want)


def test_ragged_batcher_over_generate_ragged_matches_jax():
    """``seq_buckets`` mode over each side's
    ``GenerationPredictor.generate_ragged`` (LlamaConfig.tiny, f32,
    greedy): mixed-length requests coalesce into one batch on both
    sides and every caller's tokens equal the JAX batcher's."""
    jcfg = JL.LlamaConfig.tiny(dtype=jnp.float32, use_flash_attention=False,
                               remat=False)
    tcfg = TL.LlamaConfig.tiny(dtype=torch.float32)
    jparams = JL.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = TL.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                        jparams),
                                 device="cpu")
    jpred = JI.GenerationPredictor(jparams, jcfg, max_len=64)
    tpred = TI.GenerationPredictor(tparams, tcfg, max_len=64, device="cpu")
    rs = np.random.RandomState(20)
    rows = [rs.randint(0, jcfg.vocab_size, n).astype(np.int32)
            for n in (5, 9, 12)]
    outs = {}
    for name, pred, cls in (("jax", jpred, JBatcher),
                            ("port", tpred, TBatcher)):
        def fn(batch, lens, pred=pred):
            return np.stack(pred.generate_ragged(
                [r[:n] for r, n in zip(batch, lens)], 5, page_size=4))

        with cls(fn, max_batch_size=4, max_delay_ms=200,
                 seq_buckets=[16]) as b:
            futs = [b.submit(r) for r in rows]
            outs[name] = [f.result(timeout=120) for f in futs]
        assert b.stats["batches"] == 1, b.stats
    for got, want in zip(outs["port"], outs["jax"]):
        assert got.shape == (5,)
        np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------
# the dataflow trace and the passes (tests/test_inference.py:124-328)
# --------------------------------------------------------------------------

class JFanOut(pt.nn.Layer):
    def __init__(self):
        super().__init__()
        self.conv = pt.nn.Conv2D(3, 3, 1)
        self.bn = pt.nn.BatchNorm2D(3)

    def forward(self, x):
        h = self.conv(x)
        return self.bn(h) + h


class TFanOut(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = _layers.conv(3, 3, 1, bias=True)
        self.bn = _layers.BatchNorm2D(3)

    def forward(self, x):
        h = self.conv(x)
        return self.bn(h) + h


class JMultiOut(JFanOut):
    def forward(self, x):
        h = self.conv(x)
        return self.bn(h), h


class TMultiOut(nn.Module):
    """torch's own conv and BN."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 3, 1)
        self.bn = nn.BatchNorm2d(3)

    def forward(self, x):
        h = self.conv(x)
        return self.bn(h), h


class JReuse(JFanOut):
    def forward(self, x):
        y = self.bn(self.conv(x))
        return self.bn(self.conv(y))


class TReuse(TFanOut):
    def forward(self, x):
        y = self.bn(self.conv(x))
        return self.bn(self.conv(y))


class JDictOut(JFanOut):
    def forward(self, x):
        h = self.conv(x)
        return {"bn": self.bn(h), "raw": h}


class TDictOut(TFanOut):
    def forward(self, x):
        h = self.conv(x)
        return {"bn": self.bn(h), "raw": h}


class JHead(pt.nn.Layer):
    def forward(self, x, skip=None):
        return x + skip


class THead(nn.Module):
    def forward(self, x, skip=None):
        return x + skip


class JKwargSkip(JFanOut):
    def __init__(self):
        super().__init__()
        self.head = JHead()

    def forward(self, x):
        h = self.conv(x)
        return self.head(self.bn(h), skip=h)


class TKwargSkip(TFanOut):
    def __init__(self):
        super().__init__()
        self.head = THead()

    def forward(self, x):
        h = self.conv(x)
        return self.head(self.bn(h), skip=h)


class JChain(JFanOut):
    """conv → bn feeding only the relu: folds."""

    def forward(self, x):
        return pt.nn.functional.relu(self.bn(self.conv(x)))


class TChain(TMultiOut):
    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


# name: (JAX model, port model, BNs folded)
CASES = {"fanout": (JFanOut, TFanOut, 0),
         "returned_intermediate": (JMultiOut, TMultiOut, 0),
         "reused": (JReuse, TReuse, 0),
         "dict_out": (JDictOut, TDictOut, 0),
         "kwarg_skip": (JKwargSkip, TKwargSkip, 0),
         "chain": (JChain, TChain, 1)}


def _case_pair(name):
    """The case's JAX and port models with the same conv weights and
    seeded BN statistics, eval, and an input."""
    jcls, tcls, _ = CASES[name]
    pt.seed(0)
    jm = jcls()
    rs = np.random.RandomState(3)
    _seed_bn(jm, rs)
    jm.eval()
    tm = tcls().eval()
    with torch.no_grad():
        tm.conv.weight.copy_(torch.from_numpy(np.array(jm.conv.weight._data)))
        tm.conv.bias.copy_(torch.from_numpy(np.array(jm.conv.bias._data)))
        for tn, jn in (("_mean", "_mean"), ("_variance", "_variance"),
                       ("weight", "weight"), ("bias", "bias")):
            if not isinstance(tm.bn, _layers.BatchNorm2D):
                tn = {"_mean": "running_mean",
                      "_variance": "running_var"}.get(tn, tn)
            getattr(tm.bn, tn).copy_(torch.from_numpy(
                np.array(getattr(jm.bn, jn)._data)))
    x = np.random.RandomState(4).randn(1, 3, 4, 4).astype(np.float32)
    return jm, tm, x


def _outs(y):
    if isinstance(y, dict):
        return [y[k] for k in sorted(y)]
    return list(y) if isinstance(y, (tuple, list)) else [y]


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t.data)


@pytest.mark.parametrize("name", sorted(CASES))
def test_trace_consumers_match_jax(name):
    """Per layer event, in order: how many times its output is consumed
    (the model's outputs and keyword arguments count), and how many
    times each layer ran."""
    jm, tm, x = _case_pair(name)
    jt = j_trace(jm, pt.to_tensor(x))
    tt = t_trace(tm, torch.from_numpy(x))

    def per_layer(tr):
        return [(tr.consumers.get(id(ev[3]), 0), tr.layer_calls[id(ev[1])])
                for ev in tr.events if ev[0] == "layer"]

    assert per_layer(tt) == per_layer(jt)
    assert len(tt.traced_ids) > 0
    assert not tm.training


@pytest.mark.parametrize("name", sorted(CASES))
def test_fold_batch_norms_counts_and_outputs_match_jax(name):
    jm, tm, x = _case_pair(name)
    jbefore = [_np(o) for o in _outs(jm(pt.to_tensor(x)))]
    with torch.no_grad():
        tbefore = [o.numpy() for o in _outs(tm(torch.from_numpy(x)))]
    nj = JI.fold_batch_norms(jm, [(1, 3, 4, 4)])
    nt = TI.fold_batch_norms(tm, [(1, 3, 4, 4)])
    assert nt == nj == CASES[name][2]
    jafter = [_np(o) for o in _outs(jm(pt.to_tensor(x)))]
    with torch.no_grad():
        tafter = [o.numpy() for o in _outs(tm(torch.from_numpy(x)))]
    for tb, ta, jb, ja in zip(tbefore, tafter, jbefore, jafter):
        np.testing.assert_allclose(tb, jb, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(ta, ja, rtol=FOLD_RTOL, atol=FOLD_ATOL)
        if nt == 0:
            np.testing.assert_array_equal(ta, tb)
        else:
            np.testing.assert_allclose(ta, tb, rtol=FOLD_RTOL,
                                       atol=FOLD_ATOL)
    if nt:
        assert isinstance(tm.bn, nn.Identity)


def test_fold_batch_norms_resnet18_matches_jax():
    """Every BN of ResNet-18 folds (20, downsamples included) on both
    sides; the folded outputs agree with the unfolded ones and with the
    JAX folded model's; no BatchNorm is left."""
    pt.seed(0)
    jm = JM.resnet18(num_classes=7)
    _seed_bn(jm, np.random.RandomState(0))
    jm.eval()
    tm = _port(jm, "resnet18", num_classes=7)
    x = np.random.RandomState(2).randn(2, 3, 32, 32).astype(np.float32)
    with torch.no_grad():
        before = tm(torch.from_numpy(x)).numpy()
    nj = JI.fold_batch_norms(jm, [(1, 3, 32, 32)])
    nt = TI.fold_batch_norms(tm, [TJ.InputSpec([None, 3, 32, 32])])
    assert nt == nj == 20
    with torch.no_grad():
        after = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(after, before, rtol=FOLD_RTOL, atol=FOLD_ATOL)
    np.testing.assert_allclose(after, jm(pt.to_tensor(x)).numpy(),
                               rtol=FOLD_RTOL, atol=FOLD_ATOL)
    assert not any(isinstance(m, (_layers.BatchNorm2D, nn.BatchNorm2d))
                   for m in tm.modules())
    # the parameters stay f32; the folded convs gained their bias
    assert tm.conv1.bias is not None and tm.conv1.bias.dtype == torch.float32


def test_fold_batch_norms_folds_linear_and_bn1d():
    """A Linear followed by a BN (torch's Linear and BatchNorm1d, and the
    port's Linear with its [in, out] weight): the f64 fold rounded once."""
    torch.manual_seed(0)
    for lin in (nn.Linear(5, 4), _layers.Linear(5, 4)):
        if isinstance(lin, _layers.Linear):
            nn.init.normal_(lin.weight)
        bn = nn.BatchNorm1d(4)
        with torch.no_grad():
            bn.running_mean.normal_()
            bn.running_var.uniform_(0.5, 1.5)
            bn.weight.normal_()
            bn.bias.normal_()
        m = nn.Sequential(lin, bn).eval()
        x = torch.randn(3, 5)
        with torch.no_grad():
            before = m(x)
        assert TI.fold_batch_norms(m, [TJ.InputSpec([None, 5])]) == 1
        assert isinstance(m[1], nn.Identity)
        with torch.no_grad():
            torch.testing.assert_close(m(x), before, rtol=FOLD_RTOL,
                                       atol=FOLD_ATOL)


def test_fold_batch_norms_requires_eval():
    jm = pt.nn.Sequential(pt.nn.Conv2D(3, 4, 1), pt.nn.BatchNorm2D(4))
    tm = nn.Sequential(_layers.conv(3, 4, 1), _layers.BatchNorm2D(4))
    for mod, m in ((JI, jm), (TI, tm)):
        with pytest.raises(ValueError, match="eval"):
            mod.fold_batch_norms(m, [(1, 3, 4, 4)])


def test_remove_dropouts_matches_jax():
    jm = pt.nn.Sequential(pt.nn.Linear(4, 8), pt.nn.Dropout(0.5),
                          pt.nn.ReLU(), pt.nn.Dropout2D(0.1))
    tm = nn.Sequential(_layers.Linear(4, 8), _layers.Dropout(0.5),
                       nn.ReLU(), nn.Dropout2d(0.1), nn.Dropout(0.2))
    assert JI.remove_dropouts(jm) == 2
    assert TI.remove_dropouts(tm) == 3
    assert all(isinstance(tm[i], nn.Identity) for i in (1, 3, 4))
    with torch.no_grad():
        assert tm(torch.ones(2, 4)).shape == (2, 8)


def _linear_chain(jm, port_cls):
    """The port's chain of Linears with the JAX chain's weights."""
    mods = []
    for jl in jm:
        w = torch.from_numpy(np.array(jl.weight._data))
        b = torch.from_numpy(np.array(jl.bias._data))
        tl = port_cls(w.shape[0], w.shape[1])
        with torch.no_grad():
            tl.weight.copy_(w if port_cls is _layers.Linear else w.T)
            tl.bias.copy_(b)
        mods.append(tl)
    return nn.Sequential(*mods)


@pytest.mark.parametrize("port_cls", [_layers.Linear, nn.Linear],
                         ids=["paddle_linear", "torch_linear"])
def test_fuse_linear_chains_matches_jax(port_cls):
    pt.seed(0)
    jm = pt.nn.Sequential(pt.nn.Linear(4, 16), pt.nn.Linear(16, 8),
                          pt.nn.Linear(8, 2))
    tm = _linear_chain(jm, port_cls)
    x = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    with torch.no_grad():
        want = tm(torch.from_numpy(x)).numpy()
    assert JI.fuse_linear_chains(jm, [JSpec([1, 4])]) == 2
    assert TI.fuse_linear_chains(tm, [TJ.InputSpec([1, 4])]) == 2
    lins = [m for m in tm if isinstance(m, port_cls)]
    shape = (4, 2) if port_cls is _layers.Linear else (2, 4)
    assert len(lins) == 1 and tuple(lins[0].weight.shape) == shape
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(jm(pt.to_tensor(x)).data),
                               rtol=RTOL, atol=ATOL)

    class JBranchy(pt.nn.Layer):
        def __init__(self):
            super().__init__()
            self.a = pt.nn.Linear(4, 4)
            self.b = pt.nn.Linear(4, 4)

        def forward(self, x):
            h = self.a(x)
            return self.b(h) + h

    class TBranchy(nn.Module):
        def __init__(self):
            super().__init__()
            self.a = port_cls(4, 4)
            self.b = port_cls(4, 4)

        def forward(self, x):
            h = self.a(x)
            return self.b(h) + h

    assert JI.fuse_linear_chains(JBranchy(), [JSpec([1, 4])]) == 0
    assert TI.fuse_linear_chains(TBranchy(), [TJ.InputSpec([1, 4])]) == 0
