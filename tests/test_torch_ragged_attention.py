"""PyTorch port of the ragged paged attention vs the JAX package.

The same seeded numpy inputs go through ``paddle_tpu``'s
``ragged_paged_attention`` (dense reference, the Pallas kernels in
interpret mode, and tiled walks) and through the port's plain versions
(``paddle_tpu_torch.ops.kernels.ragged_paged_attention``). Contract:
``tiled_ulp_error <= TILED_ULP_BOUND`` (16 ulps of f32 at each slot's
output scale) across frameworks; inside the port, chunked == whole and
padding rows == 0 hold bitwise. The CUDA kernel itself runs only on the
card (chip_smoke.py and tests/test_torch_cuda_kernels.py).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas.ragged_paged_attention import (
    ragged_paged_attention as jax_rpa,
    ragged_paged_attention_packed as jax_rpa_packed)
from paddle_tpu_torch.ops.kernels import ragged_paged_attention as port
from paddle_tpu_torch.ops.kernels.paged_attention import (
    split_plan as paged_split_plan)
from paddle_tpu_torch.ops.kernels.ragged_paged_attention import (
    TILED_ULP_BOUND, ragged_paged_attention_packed,
    ragged_paged_attention_reference, tiled_ulp_error)


def _ragged_case(seed, S=4, Tq=6, H=4, Hkv=2, Dh=8, ps=4, P=24, pps=5,
                 scatter_tables=False):
    """One seeded ragged batch (numpy): mixed prefill spans, decode
    steps, an empty slot, partial tail pages, TRASH past the covered
    range; ``scatter_tables`` gives post-defrag (non-monotone) rows."""
    rng = np.random.RandomState(seed)
    q = rng.randn(S, Tq, H, Dh).astype(np.float32)
    kp = rng.randn(Hkv, P, ps, Dh).astype(np.float32)
    vp = rng.randn(Hkv, P, ps, Dh).astype(np.float32)
    kv_max = pps * ps
    q_len = np.zeros((S,), np.int32)
    kv_len = np.zeros((S,), np.int32)
    for s in range(S):
        kind = s % 3          # 0: prefill span, 1: decode, 2: empty
        if kind == 0:
            q_len[s] = rng.randint(2, Tq + 1)
            kv_len[s] = rng.randint(q_len[s], kv_max + 1)
        elif kind == 1:
            q_len[s] = 1
            kv_len[s] = rng.randint(1, kv_max + 1)
    if scatter_tables:
        ids = rng.permutation(P - 1)[: S * pps] + 1
    else:
        ids = np.arange(1, S * pps + 1)
    tables = ids.reshape(S, pps).astype(np.int32)
    for s in range(S):
        tables[s, -(-int(kv_len[s]) // ps):] = 0     # TRASH past the span
    return q, kp, vp, q_len, kv_len, tables


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _jax(case, **kw):
    return np.asarray(jax_rpa(*[jnp.asarray(a) for a in case], **kw))


CASES = [dict(seed=0), dict(seed=1), dict(seed=2),
         dict(seed=7, scatter_tables=True),
         dict(seed=5, pps=32, ps=8, P=129)]


@pytest.mark.parametrize("case_kw", CASES)
@pytest.mark.parametrize("jax_impl", ["dense", "pallas"])
def test_slot_major_reference_matches_jax(case_kw, jax_impl):
    """Port's one-shot slot-major reference vs the JAX dense reference
    and the one-shot Pallas kernel (interpret mode)."""
    case = _ragged_case(**case_kw)
    ref = _jax(case, impl=jax_impl, kv_tile_pages=0)
    got = ragged_paged_attention_reference(*_t(*case))
    assert tiled_ulp_error(got, ref) <= TILED_ULP_BOUND


@pytest.mark.parametrize("case_kw", CASES[:3] + CASES[4:])
@pytest.mark.parametrize("tile", [1, 3])
def test_tiled_reference_matches_jax_tiled_kernel(case_kw, tile):
    """Port's tiled walk vs the JAX tiled Pallas kernel (interpret) at
    the same tile, and vs the port's own one-shot reference."""
    case = _ragged_case(**case_kw)
    ref = _jax(case, impl="pallas", kv_tile_pages=tile)
    got = ragged_paged_attention_reference(*_t(*case), kv_tile_pages=tile)
    assert tiled_ulp_error(got, ref) <= TILED_ULP_BOUND
    one = ragged_paged_attention_reference(*_t(*case))
    assert tiled_ulp_error(got, one) <= TILED_ULP_BOUND


def test_degenerate_slots_emit_zeros():
    """Every slot empty -> all-zero output, one-shot and tiled; spans
    exactly filling their last page match JAX."""
    q, kp, vp, _, _, tables = _ragged_case(3)
    zeros = np.zeros((4,), np.int32)
    for tile in (0, 2):
        out = ragged_paged_attention_reference(
            *_t(q, kp, vp, zeros, zeros, tables), kv_tile_pages=tile)
        assert not out.any()
    q_len = np.asarray([4, 1, 2, 1], np.int32)
    kv_len = np.asarray([8, 4, 20, 12], np.int32)       # all % ps == 0
    case = (q, kp, vp, q_len, kv_len, tables)
    got = ragged_paged_attention_reference(*_t(*case))
    assert tiled_ulp_error(got, _jax(case, impl="dense")) <= TILED_ULP_BOUND


def _packed_case(seed=11):
    """Packed stream over a scattered table: slot 0's 3-token span, slot
    1's decode token, one padding token (sentinel S), slot 3's 2-token
    span; slot 2 empty."""
    rng = np.random.RandomState(seed)
    _, kp, vp, _, _, tables = _ragged_case(seed, scatter_tables=True)
    S = 4
    q_len = np.asarray([3, 1, 0, 2], np.int32)
    kv_len = np.asarray([9, 6, 0, 2], np.int32)
    tok_slot = np.asarray([0, 0, 0, 1, S, 3, 3], np.int32)
    tok_qoff = np.asarray([0, 1, 2, 0, 0, 0, 1], np.int32)
    q = rng.randn(7, 4, 8).astype(np.float32)
    return q, kp, vp, tok_slot, tok_qoff, q_len, kv_len, tables


def test_packed_matches_jax_and_slot_major():
    """The plain packed version (the tick's CPU path) vs JAX's packed
    formulation and vs the port's slot-major reference; the padding
    row is exactly zero."""
    case = _packed_case()
    ref = np.asarray(jax_rpa_packed(*[jnp.asarray(a) for a in case], tq=3,
                                    impl="packed"))
    got = ragged_paged_attention_packed(*_t(*case))
    assert got.dtype == torch.float32 and got.shape == (7, 4, 8)
    assert tiled_ulp_error(got, ref) <= TILED_ULP_BOUND
    assert not got[4].any()
    q, kp, vp, tok_slot, tok_qoff, q_len, kv_len, tables = case
    qs = np.zeros((4, 3, 4, 8), np.float32)
    qs[tok_slot[tok_slot < 4], tok_qoff[tok_slot < 4]] = q[tok_slot < 4]
    sm = ragged_paged_attention_reference(
        *_t(qs, kp, vp, q_len, kv_len, tables)).numpy()
    real = tok_slot < 4
    assert tiled_ulp_error(got.numpy()[real],
                           sm[tok_slot[real], tok_qoff[real]]) \
        <= TILED_ULP_BOUND


def test_packed_chunked_prefill_equals_whole_bitwise():
    """Inside the port, a prompt attended as two spans (KV written
    first, bottom-right causal) gives the SAME bits for the second
    span's rows as one whole span, and a row's bits do not depend on
    what else is in the stream."""
    rng = np.random.RandomState(5)
    Hkv, Dh, ps, P, pps, H, n, split = 2, 8, 4, 10, 4, 4, 10, 6
    kp = torch.from_numpy(rng.randn(Hkv, P, ps, Dh).astype(np.float32))
    vp = torch.from_numpy(rng.randn(Hkv, P, ps, Dh).astype(np.float32))
    q = torch.from_numpy(rng.randn(n, H, Dh).astype(np.float32))
    tables = torch.zeros((1, pps), dtype=torch.int32)
    tables[0, :3] = torch.tensor([7, 2, 5], dtype=torch.int32)
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32)   # noqa: E731

    whole = ragged_paged_attention_packed(
        q, kp, vp, torch.zeros(n, dtype=torch.int32),
        torch.arange(n, dtype=torch.int32), i32(n), i32(n), tables)
    part = ragged_paged_attention_packed(
        q[split:], kp, vp, torch.zeros(n - split, dtype=torch.int32),
        torch.arange(n - split, dtype=torch.int32), i32(n - split), i32(n),
        tables)
    assert torch.equal(whole[split:], part)
    # the same rows beside a padding token and another slot's decode
    tables2 = torch.cat([tables, torch.tensor([[9, 0, 0, 0]],
                                              dtype=torch.int32)])
    mixed = ragged_paged_attention_packed(
        torch.cat([q[split:], q[:2]]), kp, vp,
        i32(*([0] * (n - split)), 2, 1),
        i32(*range(n - split), 0, 0), i32(n - split, 1), i32(n, 3),
        tables2)
    assert torch.equal(mixed[:n - split], part)
    assert not mixed[n - split].any()


def test_wrapper_dispatch_on_cpu():
    """CPU tensors: "auto" and "reference" run the plain packed version
    and launch nothing; "kernel" raises (a CUDA kernel cannot take CPU
    tensors); an unknown impl raises."""
    case = _t(*_packed_case())
    before = ragged_paged_attention_packed.launches
    a = ragged_paged_attention_packed(*case)
    b = ragged_paged_attention_packed(*case, impl="reference")
    assert torch.equal(a, b)
    assert ragged_paged_attention_packed.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        ragged_paged_attention_packed(*case, impl="kernel")
    with pytest.raises(ValueError, match="impl"):
        ragged_paged_attention_packed(*case, impl="pallas")


@pytest.mark.parametrize("pps,ps,chunks", [
    (511, 1, 1), (32, 16, 1), (33, 16, 2), (64, 16, 2), (1, 1, 1),
    (1025, 16, 33)])
def test_split_plan_at_the_chunk_edges(pps, ps, chunks):
    """The ragged kernel's fixed split, shared with the paged kernel: a
    table of pps pages of ps keys (C - 1, C, C + 1, 2C and 1 keys, and
    the 16k engine table) gives ceil(pps * ps / KEY_CHUNK) chunks, the
    same for a stream of 1 or 300 tokens; the workspace holds (O, m, l)
    for each of the T x H rows and every chunk, none for one chunk."""
    assert port.split_plan is paged_split_plan
    for T in (1, 300):
        got, floats = port.split_plan(pps * ps, T * 32, 128)
        assert got == chunks
        assert floats == (0 if chunks == 1 else chunks * T * 32 * 130)
    assert port.KEY_CHUNK == 512


def test_tiled_ulp_error_is_at_row_scale():
    """The metric divides by each slot's largest reference component:
    one f32 ulp of a slot's scale reads as 1 wherever it lands."""
    ref = np.asarray([[1.0, 0.5], [4.0, 1e-6]], np.float32)
    got = ref.copy()
    got[1, 1] += 4.0 * np.finfo(np.float32).eps
    assert tiled_ulp_error(got, ref) == pytest.approx(1.0)
    assert port.tiled_ulp_error(ref, ref) == 0.0
