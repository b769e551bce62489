"""The port's CUDA kernels on the card (marker ``cuda``; skipped without
one). They reuse chip_smoke.py's cases: the ragged kernel's at a smaller
geometry than its Llama-3-8B one, the train-step kernels' at the 8B
training geometry. Run them on a machine with an NVIDIA Hopper card and
nvcc, from the repository root (the package conftest imports JAX, which
the card's machine need not have):

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda_kernels.py
"""
import pytest
import torch

import chip_smoke as smoke

pytestmark = pytest.mark.cuda

GEOM = dict(H=8, Hkv=2, Dh=128, ps=16)
CASES = {
    "serving_mix": dict(slots=[(40, 40), (70, 333), (1, 1), (1, 200),
                               (0, 0), (1, 130)], pps=24, n_pad=2),
    "degenerate": dict(slots=[(5, 5), (0, 0), (1, 17), (3, 40), (0, 0),
                              (1, 16)], pps=4, n_pad=2, shuffle=True,
                       nan_garbage=True),
    "group_1": dict(slots=[(9, 300), (1, 65)], pps=20),
    "group_8": dict(slots=[(11, 150), (0, 0), (1, 33)], pps=10, n_pad=1),
}
# H per case: G = H / Hkv query heads share a kv head (1, 4 or 8)
HEADS = {"group_1": 2, "group_8": 16}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (runs on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain_version(cuda, name):
    """f32 within TILED_ULP_BOUND of the f64 evaluation, bf16 within the
    smoke's stated bounds, padding rows zero, outputs finite."""
    geom = dict(GEOM, H=HEADS.get(name, GEOM["H"]))
    smoke.check_case(name, smoke.make_case(**CASES[name], **geom,
                                           device=cuda))


@pytest.mark.parametrize("H", [2, 8, 16])
def test_kernel_rows_are_batch_invariant(cuda, H):
    """Bitwise: per-slot streams equal the mixed batch's rows, and a span
    attended in two chunks equals the whole span (rows regroup across
    blocks differently in each)."""
    case = smoke.make_case(**CASES["serving_mix"], **dict(GEOM, H=H),
                           device=cuda)
    smoke.check_row_invariance(case, split_slot=1, split=29)


@pytest.mark.parametrize("case", sorted(smoke.FLASH_CASES))
def test_flash_attention_matches_plain_version(cuda, case):
    """Forward, dq, dk and dv at the 8B attention geometry: f32 vs the f64
    evaluation, bf16 vs the bf16 plain version and vs f64, within the
    smoke's TRAIN_BOUNDS; two backward launches bitwise equal."""
    T, S = smoke.FLASH_CASES[case]
    smoke.check_bounds(case, smoke.check_flash(T, S, seed=3))


def test_rms_norm_matches_plain_version(cuda):
    """Forward, dx and dw at [2048, 4096]; dx and dw bitwise equal over
    two launches."""
    smoke.check_bounds("rms_norm", smoke.check_rms_norm(seed=4))


def test_rope_matches_plain_version(cuda):
    """Forward at theta 500000 and the backward (-positions) returning
    the input."""
    smoke.check_bounds("rope", smoke.check_rope(seed=5))


def test_train_step_runs_every_layer_through_the_kernels(cuda):
    """make_train_step on llama3_8b's width with 2 layers: launches per
    step equal the formula, the loss falls, and the first loss agrees
    with the plain versions' on the same state."""
    smoke.train_phase(num_layers=2)


def test_train_kernels_count_launches_and_reject_bad_input(cuda):
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import fused_norm_rope as nr
    q = torch.randn(1, 64, 4, 128, device=cuda)
    k = torch.randn(1, 64, 2, 128, device=cuda)
    x = torch.randn(64, 256, device=cuda)
    w = torch.ones(256, device=cuda)
    pos = torch.arange(64, device=cuda)[None]
    before = (fa.flash_attention_fwd.launches, nr.rms_norm_fwd.launches,
              nr.rope_rotate.launches)
    fa.flash_attention(q, k, k)
    fa.flash_attention(q, k, k, impl="reference")
    nr.fused_rms_norm(x, w)
    nr.fused_rms_norm(x, w, impl="reference")
    nr.fused_rope(q, k, pos)             # int64 positions are converted
    assert (fa.flash_attention_fwd.launches, nr.rms_norm_fwd.launches,
            nr.rope_rotate.launches) == tuple(b + 1 for b in before)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q[..., :96].contiguous(),
                           k[..., :96].contiguous(),
                           k[..., :96].contiguous(), impl="kernel")
    with pytest.raises(TypeError, match="weight"):
        nr.fused_rms_norm(x, w.bfloat16(), impl="kernel")


def test_kernel_counts_launches_and_rejects_bad_input(cuda):
    from paddle_tpu_torch.ops.kernels.ragged_paged_attention import (
        ragged_paged_attention_packed as rpa)
    case = smoke.make_case(**CASES["group_1"], **GEOM, device=cuda)
    before = rpa.launches
    smoke.run_rpa(case, "auto")
    smoke.run_rpa(case, "reference")
    assert rpa.launches == before + 1
    with pytest.raises(TypeError, match="int32"):
        smoke.run_rpa(dict(case, q_len=case["q_len"].long()), "kernel")
    with pytest.raises(ValueError, match="head_dim"):
        smoke.run_rpa(smoke.make_case(**CASES["group_1"],
                                      **dict(GEOM, Dh=96), device=cuda),
                      "kernel")
