"""The port's conv epilogue vs the JAX package's: ``matmul_bias_act`` (the
1x1-conv kernel's entry), ``conv_bias_act``, the space-to-depth stem and
``conv_bn_act_nchw`` (the conv-bn fold's arithmetic).

Inputs, weights and BN statistics come from numpy with a seed and go
through both packages. The JAX side takes its Pallas route
(``impl="pallas"``, the kernel in interpret mode) wherever its tiling
admits the shape, else its jnp formulation; the port runs its plain
versions (CPU tensors). Contract (f32): rtol 1e-5 and atol 1e-5 × the
row's largest reference value (f32 sums of up to 1152 products in
another order); the space-to-depth transforms bitwise."""
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (a worker's share of the cores)

import jax.numpy as jnp

from paddle_tpu.ops.fused import conv_epilogue as JF
from paddle_tpu.ops.pallas import conv_epilogue as JK
from paddle_tpu_torch.ops.fused import conv_epilogue as TF
from paddle_tpu_torch.ops.kernels import conv_epilogue as TK

RTOL = 1e-5


def _close(got, want, rtol=RTOL, atol_scale=1e-5):
    """``|got − want| <= rtol·|want| + atol_scale · (row's max |want|)``,
    rows along the last axis."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max(axis=-1, keepdims=True)
    np.testing.assert_array_less(
        np.abs(got - want), rtol * np.abs(want) + atol_scale * scale + 1e-30)


def _t(x):
    return torch.from_numpy(np.array(x))


# (M, K, N): one the TPU kernel tiles, and the three the JAX entry sends to
# jnp: N = 64 (N % 128), M = 2 (M % 8), and layer 4's M = 49 at B 1
MBA_SHAPES = {"tiled": (128, 256, 256), "n64": (128, 64, 64),
              "m2": (2, 512, 256), "m49": (49, 512, 128)}


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", sorted(MBA_SHAPES))
def test_matmul_bias_act_matches_jax(shape, relu):
    M, K, N = MBA_SHAPES[shape]
    rs = np.random.RandomState(M + K + N)
    x = rs.randn(M, K).astype(np.float32)
    w = (rs.randn(K, N) / np.sqrt(K)).astype(np.float32)
    b = rs.randn(N).astype(np.float32)
    want = JK.matmul_bias_act(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                              relu=relu,
                              tiles=JK.default_tiles(M, K, N, jnp.float32))
    got = TK.matmul_bias_act(_t(x), _t(w), _t(b), relu=relu)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    _close(got.numpy(), want)
    if relu:
        assert (got >= 0).all()


def test_matmul_bias_act_bf16_matches_jax_kernel():
    """bf16 through the TPU kernel (interpret mode) and the plain version:
    both an f32 sum plus the f32 bias rounded once, so at most one bf16
    ulp (2^-7 of the row's scale, rounding to nearest on either side)
    apart."""
    M, K, N = MBA_SHAPES["tiled"]
    rs = np.random.RandomState(5)
    x = rs.randn(M, K).astype(np.float32)
    w = (rs.randn(K, N) / np.sqrt(K)).astype(np.float32)
    b = rs.randn(N).astype(np.float32)
    want = JK.matmul_bias_act(jnp.asarray(x, jnp.bfloat16),
                              jnp.asarray(w, jnp.bfloat16), jnp.asarray(b),
                              tiles=JK.default_tiles(M, K, N, jnp.bfloat16))
    got = TK.matmul_bias_act(_t(x).bfloat16(), _t(w).bfloat16(), _t(b))
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), np.asarray(want, np.float32), rtol=0,
           atol_scale=2.0 ** -7)


def test_matmul_bias_act_checks_its_operands():
    x, w, b = torch.zeros(4, 16), torch.zeros(16, 8), torch.zeros(8)
    with pytest.raises(ValueError, match="impl"):
        TK.matmul_bias_act(x, w, b, impl="pallas")
    with pytest.raises(ValueError, match="bias"):
        TK.matmul_bias_act(x, w, torch.zeros(16))
    with pytest.raises(ValueError, match="CUDA"):
        TK.matmul_bias_act(x, w, b, impl="kernel")


# conv cases: (Cin, Cout, k, stride, pad, groups); image 8x8, B 2
CONV_CASES = {
    "1x1_s1": (64, 128, 1, 1, 0, 1),      # the kernel route (M = 128)
    "3x3_s1": (16, 32, 3, 1, 1, 1),
    "3x3_s2": (16, 32, 3, 2, 1, 1),
    "1x1_s2": (32, 64, 1, 2, 0, 1),       # ResNet's downsample
    "3x3_grouped": (32, 32, 3, 1, 1, 8),  # ResNeXt's conv2
    # a 1x1 the kernel cannot take (ShuffleNetV2 x 1.0's branch width):
    # the conv route, chosen by the shapes
    "1x1_s1_width_58": (58, 58, 1, 1, 0, 1),
}


def _conv_inputs(case, seed):
    cin, cout, k, s, p, g = CONV_CASES[case]
    rs = np.random.RandomState(seed)
    x = rs.randn(2, 8, 8, cin).astype(np.float32)
    w = (rs.randn(k, k, cin // g, cout) / np.sqrt(k * k * cin // g)
         ).astype(np.float32)
    b = rs.randn(cout).astype(np.float32)
    kw = dict(strides=(s, s), padding=((p, p), (p, p)), groups=g)
    return x, w, b, kw


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv_bias_act_matches_jax(case, relu):
    x, w, b, kw = _conv_inputs(case, seed=len(case) + relu)
    want = JF.conv_bias_act(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                            relu=relu, impl="pallas", **kw)
    got = TF.conv_bias_act(_t(x), _t(w), _t(b), relu=relu, **kw)
    assert got.shape == tuple(want.shape)
    _close(got.numpy(), want)


def test_space_to_depth_matches_jax_bitwise():
    x = np.random.RandomState(0).randn(2, 8, 6, 3).astype(np.float32)
    want = np.asarray(JF.space_to_depth_nhwc(jnp.asarray(x)))
    got = TF.space_to_depth_nhwc(_t(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_space_to_depth_stem_kernel_matches_jax_bitwise():
    w = np.random.RandomState(1).randn(7, 7, 3, 16).astype(np.float32)
    want = np.asarray(JF.space_to_depth_stem_kernel(jnp.asarray(w)))
    got = TF.space_to_depth_stem_kernel(_t(w)).numpy()
    np.testing.assert_array_equal(got, want)


def test_stem_s2d_conv_matches_jax_and_the_strided_conv():
    """The s2d stem against JAX's, and against the 7x7 / stride-2 / pad-3
    conv it stands for (the same 147 products, associated per phase)."""
    rs = np.random.RandomState(2)
    x = rs.randn(2, 3, 16, 16).astype(np.float32)
    w = (rs.randn(16, 3, 7, 7) / np.sqrt(147)).astype(np.float32)
    want = JF.stem_s2d_conv_nchw(jnp.asarray(x), jnp.asarray(w))
    got = TF.stem_s2d_conv_nchw(_t(x), _t(w))
    _close(got.numpy(), want)
    direct = torch.nn.functional.conv2d(_t(x), _t(w), stride=2, padding=3)
    _close(got.numpy(), direct.numpy())


# conv_bn_act_nchw sites: (Cin, Cout, k, stride, pad, image); the stem goes
# through space-to-depth
BN_CASES = {
    "stem": (3, 16, 7, 2, 3, 16),
    "1x1": (64, 128, 1, 1, 0, 8),
    "3x3_s2": (16, 32, 3, 2, 1, 8),
}


def bn_stats(rs, c):
    """Seeded BN statistics and affine, far from the identity fold: means
    N(0, 0.1), variances U(0.5, 1.5), γ ≈ 1 and β ≈ 0 with noise."""
    return dict(gamma=(1 + 0.1 * rs.randn(c)).astype(np.float32),
                beta=(0.1 * rs.randn(c)).astype(np.float32),
                mean=(0.1 * rs.randn(c)).astype(np.float32),
                var=rs.uniform(0.5, 1.5, c).astype(np.float32))


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("case", sorted(BN_CASES))
def test_conv_bn_act_nchw_matches_jax(case, relu):
    cin, cout, k, s, p, img = BN_CASES[case]
    rs = np.random.RandomState(len(case))
    x = rs.randn(2, cin, img, img).astype(np.float32)
    w = (rs.randn(cout, cin, k, k) / np.sqrt(cin * k * k)).astype(np.float32)
    st = bn_stats(rs, cout)
    kw = dict(eps=1e-5, strides=(s, s), padding=((p, p), (p, p)), relu=relu)
    want = JF.conv_bn_act_nchw(jnp.asarray(x), jnp.asarray(w),
                               **{n: jnp.asarray(v) for n, v in st.items()},
                               impl="pallas", **kw)
    got = TF.conv_bn_act_nchw(_t(x), _t(w),
                              **{n: _t(v) for n, v in st.items()}, **kw)
    assert got.shape == tuple(want.shape) and got.dtype == torch.float32
    _close(got.numpy(), want)
