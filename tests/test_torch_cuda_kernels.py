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
    # the fixed key chunks' edges (KEY_CHUNK = 512): decode rows over
    # C - 1, C, C + 1, 2C and 1 keys, a span whose causal limits cross a
    # chunk boundary inside one query tile, and a span's last tokens
    # followed in the stream by decode rows
    "chunk_edges": smoke.CASE_E,
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


def test_kernel_rows_are_invariant_across_chunk_edges(cuda):
    """Bitwise, over the key-chunk edges: per-slot streams (decode alone:
    one 16-row group a block) equal the mixed stream's rows (four), and
    the 40-token span attended as 21 + 19 tokens equals the whole span."""
    case = smoke.make_case(**CASES["chunk_edges"], **GEOM, device=cuda)
    smoke.check_row_invariance(case, split_slot=5, split=21)


@pytest.mark.parametrize("case", sorted(smoke.FLASH_CASES))
def test_flash_attention_matches_plain_version(cuda, case):
    """Forward, dq, dk and dv at the 8B attention geometry: f32 vs the f64
    evaluation, bf16 vs the bf16 plain version and vs f64, within the
    smoke's TRAIN_BOUNDS; two backward launches bitwise equal."""
    T, S = smoke.FLASH_CASES[case]
    smoke.check_bounds(case, smoke.check_flash(T, S, seed=3))


def test_flash_attention_batch_and_head_dim_64(cuda):
    """B 2 (every prefill path's batch) and the Dh-64 instantiation, at
    H 8 / Hkv 2, T 700, S 1024: forward and backward within the smoke's
    TRAIN_BOUNDS, two backward launches bitwise equal."""
    smoke.check_bounds("b2_dh64", smoke.check_flash(
        **smoke.FLASH_BATCH_CASE, seed=7, gm=smoke.FLASH_BATCH_GEOM))


def test_flash_attention_without_causal_mask(cuda):
    """causal=False (every query row sees all S keys; no main path runs
    it) at the same shape, within the same bounds."""
    smoke.check_bounds("full_mask", smoke.check_flash(
        **smoke.FLASH_BATCH_CASE, seed=8, gm=smoke.FLASH_BATCH_GEOM,
        causal=False))


def test_rms_norm_matches_plain_version(cuda):
    """Forward, dx and dw at every shape of the smoke's RMS_SHAPES (N 2048,
    2047, 1, 15, 17 at D 4096; D 2560 and 8192); dx and dw bitwise over
    two launches and on two streams at once; dx rows alone and in 17-row
    slices bitwise."""
    smoke.check_bounds("rms_norm", smoke.check_rms_norm(seed=4))


def test_rms_norm_backward_rejects_what_it_does_not_take(cuda):
    """impl="kernel" raises on a width over 8192 or off a multiple of 8,
    and on a 16-byte misaligned x; N 0 gives an empty dx and a zero dw."""
    from paddle_tpu_torch.ops.kernels import fused_norm_rope as nr
    for D in (8200, 12):
        x = torch.randn(4, D, device=cuda)
        w = torch.ones(D, device=cuda)
        r = torch.ones(4, 1, device=cuda)
        with pytest.raises(ValueError, match="multiple of 8"):
            nr.rms_norm_bwd(x, w, r, x, impl="kernel")
    flat = torch.randn(4 * 64 + 1, device=cuda)
    x = flat[1:].view(4, 64)
    with pytest.raises(ValueError, match="aligned"):
        nr.rms_norm_bwd(x, torch.ones(64, device=cuda),
                        torch.ones(4, 1, device=cuda), x, impl="kernel")
    x = torch.empty(0, 64, device=cuda)
    dx, dw = nr.rms_norm_bwd(x, torch.ones(64, device=cuda),
                             torch.empty(0, 1, device=cuda), x,
                             impl="kernel")
    assert dx.shape == (0, 64) and torch.equal(dw, torch.zeros_like(dw))


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


# ---------------------------------------------------------------------------
# decode kernels: paged attention and int8 matmul
# ---------------------------------------------------------------------------

PAGED_CASES = {
    "mixed_page_4": dict(lens=[1, 9, 64, 200, 33], ps=4),
    "mixed_page_16": dict(lens=[700, 16, 1, 129], ps=16),
    "chunk_edges": smoke.PAGED_EDGES,
}


@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("name", sorted(PAGED_CASES))
def test_paged_attention_matches_plain_version(cuda, name, G):
    """Both modes, o, m and l, f32 vs f64 and bf16 vs the plain version
    and f64 within the smoke's bounds; NaN in every unread slot; alone
    and re-placed sequences bitwise equal."""
    geom = dict(H=2 * G, Hkv=2, Dh=128)
    case = smoke.make_paged_case(**PAGED_CASES[name], **geom, device=cuda)
    smoke.check_paged_case(name, case)
    smoke.check_paged_invariance(case)


@pytest.mark.parametrize("K", [1032, 4096])
@pytest.mark.parametrize("M", [1, 8, 33, 200])
def test_int8_matmul_matches_plain_version(cuda, M, K):
    """bf16 within one ulp of the plain version and f64, f32 within the
    smoke's bound; rows bitwise equal at every M and in reverse order.
    N = 208 leaves ragged column tiles; K = 1032 sums K in one part with a
    ragged last stage, K = 4096 in 4 parts of 1024 (spread across blocks
    up to 256 rows)."""
    smoke.check_int8(f"M{M}", K, 208, seed=M, timing=False,
                     ms_list=(1, M))


@pytest.mark.parametrize("K", [1032, 4096])
def test_int8_matmul_rows_bitwise_across_regime_edges(cuda, K):
    """Rows bitwise equal at M = 63, 64 (64-row items), 65 (128-row items)
    and 257 (the parts of K summed in one block, where up to 256 rows
    spread them across blocks), and in reverse order; the bounds as
    above."""
    smoke.check_int8(f"edges K{K}", K, 208, seed=K, timing=False,
                     ms_list=(63, 64, 65, 257))


def test_decode_kernels_count_launches_and_reject_bad_input(cuda):
    from paddle_tpu_torch.ops.kernels import int8_matmul as im
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    case = smoke.make_paged_case(**PAGED_CASES["mixed_page_16"], H=8,
                                 Hkv=2, Dh=128, device=cuda)
    x = torch.randn(4, 256, device=cuda).bfloat16()
    q = torch.ones(256, 64, dtype=torch.int8, device=cuda)
    s = torch.ones(64, device=cuda)
    before = (pa.paged_attention.launches, pa.paged_attention_stats.launches,
              im.int8_matmul.launches)
    smoke.run_paged(case, "auto", stats=False)
    smoke.run_paged(case, "auto")
    smoke.run_paged(case, "reference")
    im.int8_matmul(x, q, s)
    im.int8_matmul(x, q, s, impl="reference")
    assert (pa.paged_attention.launches, pa.paged_attention_stats.launches,
            im.int8_matmul.launches) == tuple(b + 1 for b in before)
    with pytest.raises(TypeError, match="int32"):
        smoke.run_paged(dict(case, lengths=case["lengths"].long()), "kernel")
    with pytest.raises(ValueError, match="head_dim"):
        smoke.run_paged(smoke.make_paged_case(lens=[5], ps=4, H=2, Hkv=2,
                                              Dh=96, device=cuda), "kernel")
    with pytest.raises(ValueError, match="multiple of 16"):
        im.int8_matmul(x, q[:, :40].contiguous(), s[:40], impl="kernel")
    with pytest.raises(TypeError, match="int8"):
        im.int8_matmul(x, q.float(), s, impl="kernel")


def test_int8_matmul_on_two_streams(cuda):
    """Decode launches on two streams at once each keep their own tile
    counters: every output equals the one-stream result bitwise."""
    from paddle_tpu_torch.ops.kernels import int8_matmul as im
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(8, 4096, generator=g, device=cuda).bfloat16()
    q = torch.randint(-127, 128, (4096, 4096), generator=g, device=cuda,
                      dtype=torch.int8)
    s = torch.rand(4096, generator=g, device=cuda) / 127
    want = im.int8_matmul(x, q, s, impl="kernel")
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = {i: [] for i in range(2)}
    for _ in range(20):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[i].append(im.int8_matmul(x, q, s, impl="kernel"))
    torch.cuda.synchronize()
    for o in outs[0] + outs[1]:
        assert torch.equal(o, want)


def test_decode_attention_on_two_streams(cuda):
    """Paged (with stats) and ragged launches with several key chunks on
    two streams at once each keep their own last-block counters: every
    output equals the one-stream result bitwise."""
    paged = smoke.cast(smoke.make_paged_case(
        **PAGED_CASES["chunk_edges"], H=8, Hkv=2, Dh=128, device=cuda),
        torch.bfloat16)
    ragged = smoke.cast(smoke.make_case(**CASES["chunk_edges"], **GEOM,
                                        device=cuda), torch.bfloat16)
    want = (smoke.run_paged(paged, "kernel"), smoke.run_rpa(ragged, "kernel"))
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = []
    for _ in range(10):
        for st in streams:
            with torch.cuda.stream(st):
                outs.append((smoke.run_paged(paged, "kernel"),
                             smoke.run_rpa(ragged, "kernel")))
    torch.cuda.synchronize()
    for (o, m, l), r in outs:
        assert torch.equal(o, want[0][0]) and torch.equal(m, want[0][1]) \
            and torch.equal(l, want[0][2]) and torch.equal(r, want[1])


def test_paged_decode_paths_on_two_layers(cuda):
    """generate_paged with int8 weights and serving_decode_block on
    llama3_8b's width with 2 layers: kernel launches per the formulas,
    tokens in range."""
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.quantization import quantize_for_decode
    cfg = llama.LlamaConfig.llama3_8b()
    cfg.num_hidden_layers = 2
    params = llama.init_params(cfg, torch.Generator(device=cuda)
                               .manual_seed(0))
    qparams = quantize_for_decode(params, cfg)
    prompt = torch.randint(0, cfg.vocab_size, (3, 40), device=cuda,
                           generator=torch.Generator(device=cuda)
                           .manual_seed(1), dtype=torch.int32)
    lens = torch.tensor([40, 40, 40], dtype=torch.int32, device=cuda)
    smoke._zero_counts()
    paged = llama.generate_paged(qparams, prompt, lens, cfg, 5, page_size=16)
    counts = smoke._counts()
    assert counts["int8_matmul"] == (7 * 2 + 1) * 5, counts
    assert counts["paged_attention_stats"] == 2 * 4, counts
    assert paged.shape == (3, 5) and bool((paged >= 0).all()) \
        and bool((paged < cfg.vocab_size).all())
    smoke.decode_block_run(params, cfg, steps=2)


# ---------------------------------------------------------------------------
# grouped matmul (dropless MoE) and the Qwen2-MoE train step
# ---------------------------------------------------------------------------

# a small dropless layer: 256 tokens, top-2 of 8 experts, D 256, F 136 (a
# ragged last column tile, and a reduction of 136 = 4 x 32 + 8), tile_m 128
GMM_SMALL = dict(S=256, k=2, E=8, D=256, F=136, tile_m=128)


@pytest.mark.parametrize("kind", smoke.GMM_ROUTINGS)
def test_grouped_matmul_matches_plain_version(cuda, kind):
    """gmm forward and dlhs and tgmm: f32 vs the f64 evaluation, bf16 vs
    the plain version and f64, within the smoke's GMM_BOUNDS; padding rows
    and empty experts exactly 0; two launches and a shuffled tile order
    give the same bits."""
    smoke.check_gmm(kind, seed=3, geom=GMM_SMALL)


def test_tgmm_on_skewed_routing_at_ragged_widths(cuda):
    """tgmm (and gmm) on the skewed routing, with its empty experts exactly
    0 and a shuffled tile order bitwise equal, at widths the tgmm tiles do
    not divide (K 584 = 4.56 x 128, N 328 = 1.28 x 256)."""
    smoke.check_gmm("skewed", seed=4, geom=dict(GMM_SMALL, D=584, F=328))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gmm_tile_m_256_and_out_of_range_experts(cuda, dtype):
    """gmm forward and dlhs with 256-row tiles (two of the bf16 kernel's
    128-row blocks a tile) within GMM_BOUNDS of the plain version; a
    tile_expert entry outside [0, E) makes its rows NaN, with no fault,
    and leaves the other rows' bits as they were."""
    from paddle_tpu_torch.ops.kernels import grouped_matmul as gm
    g = torch.Generator(device=cuda).manual_seed(11)
    lhs = torch.randn(1024, 256, generator=g, device=cuda).to(dtype)
    w = (torch.randn(3, 256, 328, generator=g, device=cuda) / 16).to(dtype)
    te = torch.tensor([0, 2, 2, 1], dtype=torch.int32, device=cuda)
    bad = torch.tensor([0, 3, -1, 1], dtype=torch.int32, device=cuda)
    eps = smoke.BF16_EPS if dtype == torch.bfloat16 else smoke.F32_EPS
    bound = smoke.GMM_BOUNDS["plain" if dtype == torch.bfloat16 else "f32"]
    for trans, b in ((False, w), (True, w.transpose(1, 2).contiguous())):
        got = gm.gmm(lhs, b, te, 256, trans=trans, impl="kernel")
        ref = gm.gmm_reference(lhs.double() if dtype == torch.float32
                               else lhs, b.double() if dtype == torch.float32
                               else b, te, 256, trans=trans)
        assert smoke._row_ulps(got, ref, eps) <= bound
        out = gm.gmm(lhs, b, bad, 256, trans=trans, impl="kernel")
        torch.cuda.synchronize()
        assert torch.isnan(out[256:768]).all()
        assert torch.equal(out[:256], got[:256])
        assert torch.equal(out[768:], got[768:])


def test_flash_attention_with_one_query_head_per_kv_head(cuda):
    """Flash attention at G = 1 (H = Hkv = 16, Qwen2-MoE's geometry)."""
    smoke.check_bounds("flash G=1", smoke.check_flash(
        512, 512, seed=6, gm=smoke.QWEN_ATTN_GEOM), smoke.QWEN_FLASH_BOUNDS)


def test_grouped_matmul_counts_launches_and_rejects_bad_input(cuda):
    from paddle_tpu_torch.ops.kernels import grouped_matmul as gm
    lhs = torch.randn(256, 64, device=cuda).bfloat16()
    w = torch.randn(2, 64, 128, device=cuda).bfloat16()
    g = torch.randn(256, 128, device=cuda).bfloat16()
    te = torch.tensor([0, 1], dtype=torch.int32, device=cuda)
    before = (gm.gmm.launches, gm.tgmm.launches)
    gm.gmm(lhs, w, te)
    gm.gmm(lhs, w, te, impl="reference")
    gm.tgmm(lhs, g, te, 2)
    gm.tgmm(lhs, g, te, 2, impl="reference")
    assert (gm.gmm.launches, gm.tgmm.launches) == (before[0] + 1,
                                                   before[1] + 1)
    with pytest.raises(ValueError, match="tile_m"):
        gm.gmm(lhs, w, torch.tensor([0, 0, 1, 1], dtype=torch.int32,
                                    device=cuda), 64, impl="kernel")
    with pytest.raises(TypeError, match="int32"):
        gm.gmm(lhs, w, te.long(), impl="kernel")
    with pytest.raises(TypeError, match="bfloat16"):
        gm.gmm(lhs.half(), w.half(), te, impl="kernel")
    with pytest.raises(ValueError, match="multiples of 8"):
        gm.tgmm(lhs[:, :60].contiguous(), g, te, 2, impl="kernel")


def test_qwen2_moe_train_step_on_two_layers(cuda):
    """qwen2_moe.make_train_step (dropless) at Qwen1.5-MoE-A2.7B's width
    with 2 layers: launches per the formula, the loss falls, the first
    loss agrees with the plain versions' on the same state."""
    smoke.qwen_train_phase(num_layers=2)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", [(392, 2048, 512), (25088, 64, 64)])
def test_conv_epilogue_matches_plain_version(cuda, shape, relu):
    """Two of ResNet-50's 1x1 shapes at B 8 (ragged M with K 2048; N 64):
    f32 vs the f64 evaluation, bf16 vs the bf16 plain version and f64,
    within the smoke's CONV_EPILOGUE_BOUNDS; two launches bitwise equal."""
    smoke.check_conv_epilogue(*shape, seed=9, relus=(relu,))


def test_conv_epilogue_rows_are_batch_invariant_and_writes_masked(cuda):
    """B 1 rows equal the same rows at B 8 bitwise; nothing is written
    outside [M, N] for ragged M and N = 64."""
    smoke.check_conv_epilogue_rows(seed=10)
    smoke.check_conv_epilogue_edges(seed=11)


def test_conv_epilogue_rows_bitwise_across_m(cuda):
    """The same rows bitwise at M from 49 to the largest, at N 64 (64-wide
    tiles) and N 2048 (128-wide tiles, 16 column tiles)."""
    smoke.check_conv_epilogue_rows_across_m(
        ((1024, 64, (49, 392, 25088)), (1024, 2048, (49, 392, 1568))),
        seed=12)


def test_conv_epilogue_counts_launches_and_rejects_bad_input(cuda):
    from paddle_tpu_torch.ops.kernels import conv_epilogue as ce
    x = torch.randn(49, 64, device=cuda, dtype=torch.bfloat16)
    w = torch.randn(64, 64, device=cuda, dtype=torch.bfloat16)
    b = torch.randn(64, device=cuda)
    before = ce.matmul_bias_act.launches
    ce.matmul_bias_act(x, w, b)
    ce.matmul_bias_act(x, w, b, impl="reference")
    assert ce.matmul_bias_act.launches == before + 1
    with pytest.raises(ValueError, match="multiples of 8"):
        ce.matmul_bias_act(x[:, :60], w[:60], b)
    with pytest.raises(ValueError, match="contiguous"):
        ce.matmul_bias_act(x[:, ::2], w[::2], b)
    with pytest.raises(TypeError, match="bias"):
        ce.matmul_bias_act(x, w, b.bfloat16())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ce.matmul_bias_act(x.half(), w.half(), b)


def test_folded_resnet50_runs_its_1x1_sites_on_the_kernel(cuda):
    """One folded bf16 forward at B 2, 64 x 64: 33 launches, no input
    copied, logits within the smoke's bound of the plain versions'."""
    from paddle_tpu_torch.analysis import fold_conv_bn
    from paddle_tpu_torch.ops.kernels import conv_epilogue as ce
    model = smoke.make_resnet50(torch.bfloat16)
    folded, fired = fold_conv_bn(model)
    plain, _ = fold_conv_bn(model, impl="reference")
    assert fired == {"conv-bn-fold": 53}
    x = torch.randn(2, 3, 64, 64, device=cuda).bfloat16()
    before, copies = ce.matmul_bias_act.launches, \
        ce.matmul_bias_act.input_copies
    with torch.no_grad():
        got, ref = folded(x), plain(x)
    assert ce.matmul_bias_act.launches == before + 33
    assert ce.matmul_bias_act.input_copies == copies
    scale = float(ref.float().abs().max())
    assert float((got.float() - ref.float()).abs().max()) <= \
        smoke.RESNET_BF16_LOGITS_REL * scale


@pytest.mark.parametrize("name", ["shufflenet_v2_x1_0", "mobilenet_v2",
                                  "inception_v3"])
def test_folded_zoo_models_run_their_kernel_sites(cuda, name):
    """One folded bf16 forward at B 2: launches = the smoke's pinned
    kernel sites (ShuffleNetV2 x 1.0's routed 1x1 sites launch nothing,
    and nothing raises), copies as pinned, logits within the smoke's
    bound of the plain versions'."""
    from paddle_tpu_torch.analysis import fold_conv_bn
    from paddle_tpu_torch.ops.kernels import conv_epilogue as ce
    _, factory, kwargs, size, chans = next(
        m for m in smoke.ZOO_MODELS if m[0] == name)
    fired, sites, copies = smoke.ZOO_SITES[name]
    model = smoke.make_zoo_model(factory, kwargs, seed=0).bfloat16()
    folded, got_fired = fold_conv_bn(model)
    plain, _ = fold_conv_bn(model, impl="reference")
    assert got_fired == {"conv-bn-fold": fired}
    x = torch.randn(2, chans, size, size, device=cuda).bfloat16(
    ).contiguous(memory_format=torch.channels_last)
    before, copied = ce.matmul_bias_act.launches, \
        ce.matmul_bias_act.input_copies
    with torch.no_grad():
        got = folded(x)
        assert ce.matmul_bias_act.launches == before + sites
        assert ce.matmul_bias_act.input_copies == copied + copies
        ref = plain(x)
    scale = float(ref.float().abs().max())
    assert float((got.float() - ref.float()).abs().max()) <= \
        smoke.ZOO_BF16_LOGITS_REL * scale
