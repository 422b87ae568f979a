"""The port's CUDA kernels on the card, held against their plain PyTorch
versions at small shapes, in float32 and bfloat16. Marked `gpu`: each test
skips itself where there is no card. This file imports neither JAX nor the
JAX package, so it runs on a machine with only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Tolerances: float32 at atol = rtol = 1e-4 (sums in another order);
bfloat16 outputs at 2e-2 (rounding at 2^-8, sums in another order)."""

import pytest
import torch

from repro_torch import kernels as K
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.moe_gmm import ops as moe_ops

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, shape, dtype, dev, scale=1.0):
    return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)


def _close(out, ref, dtype):
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s,h,hkv,d,window", [
    (1, 37, 4, 4, 64, 0), (2, 130, 8, 2, 128, 0), (1, 100, 4, 1, 64, 24),
    # RecurrentGemma's local attention: MQA 16/1 at head_dim 256, windowed
    (1, 300, 16, 1, 256, 128), (2, 70, 4, 1, 256, 0),
    # StableLM-2 3B's head_dim 80, and three query heads per KV head
    (1, 100, 6, 2, 80, 0), (2, 70, 4, 4, 80, 16), (1, 90, 6, 2, 128, 0),
    # MLA's expanded prefill: head_dim 192 (128 + 64 RoPE columns)
    (1, 90, 4, 4, 192, 0), (2, 70, 4, 4, 192, 16),
])
def test_flash_attention_kernel_matches_plain(card, dtype, b, s, h, hkv, d,
                                              window):
    gen = torch.Generator(device=card).manual_seed(s)
    q = _randn(gen, (b, s, h, d), dtype, card)
    k = _randn(gen, (b, s, hkv, d), dtype, card)
    v = _randn(gen, (b, s, hkv, d), dtype, card)
    n = K.flash_attention.launches
    by_route = dict(K.flash_attention.launches_by_route)
    out = K.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert K.flash_attention.launches == n + 1
    route = flash_ops.route(dtype)
    assert K.flash_attention.launches_by_route[route] == by_route[route] + 1
    _close(out, K.flash_attention_plain(q, k, v, window=window), dtype)


# The bf16 wgmma route: S not a multiple of the 64/128-row tiles, every head
# dim, GQA and MQA, windows the sequence outgrows, lse, B > 1 (the next
# batch's rows inside a tile), and both query tiles (BQ = 64 at D = 256
# and where B*H*ceil(S/128) < 132, else 128).
@pytest.mark.parametrize("b,s,h,hkv,d,window", [
    (2, 37, 4, 4, 64, 0),            # BQ 64
    (2, 300, 32, 8, 64, 24),         # BQ 128, GQA 32/8
    (2, 130, 32, 8, 128, 0),         # BQ 64, GQA 32/8
    (3, 1000, 16, 4, 128, 24),       # BQ 128
    (1, 300, 16, 1, 256, 128),       # MQA 16/1
    (1, 2100, 16, 1, 256, 2048),     # RecurrentGemma's window
    (4, 512, 16, 16, 128, 0),        # the training shape
    (1, 512, 32, 32, 80, 0),         # StableLM-2 3B: head_dim 80, BQ 128
    (2, 130, 32, 32, 80, 48),        # head_dim 80, BQ 64, windowed
    (1, 512, 32, 32, 64, 0),         # StableLM-2 1.6B
    (1, 512, 24, 8, 128, 0),         # Minitron-4B: GQA 24/8, group 3
    (1, 512, 128, 128, 192, 0),      # DeepSeek-V2's MLA prefill, BQ 128
    (2, 130, 8, 8, 192, 0),          # head_dim 192, BQ 64
    (1, 300, 16, 16, 192, 64),       # head_dim 192, windowed
])
def test_flash_attention_wgmma_route_matches_plain(card, b, s, h, hkv, d,
                                                   window):
    gen = torch.Generator(device=card).manual_seed(s + d)
    q, k, v = (_randn(gen, (b, s, n, d), torch.bfloat16, card)
               for n in (h, hkv, hkv))
    n = K.flash_attention.launches_by_route["wgmma"]
    out, lse = K.flash_attention(q, k, v, window=window, lse=True)
    again, lse_again = K.flash_attention(q, k, v, window=window, lse=True)
    torch.cuda.synchronize()
    assert K.flash_attention.launches_by_route["wgmma"] == n + 2
    ref, ref_lse = K.flash_attention_plain(q, k, v, window=window, lse=True)
    _close(out, ref, torch.bfloat16)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)
    assert torch.equal(out, again) and torch.equal(lse, lse_again)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_padded_prefill_on_card_matches_plain(card, dtype):
    """MLA's prefill route: v [.., 128] zero-padded to the keys' 192
    columns, through K3 at head_dim 192, the padded columns dropped,
    against the plain attention over the unpadded v."""
    from repro_torch.models import mla
    from repro_torch.models.attention import attend

    b, s, h = 1, 200, 8
    gen = torch.Generator(device=card).manual_seed(192)
    q, k = (_randn(gen, (b, s, h, 192), dtype, card) for _ in range(2))
    v = _randn(gen, (b, s, h, 128), dtype, card)
    n = K.flash_attention.launches
    out = mla.attend_padded(q, k, v)
    torch.cuda.synchronize()
    assert K.flash_attention.launches == n + 1
    assert tuple(out.shape) == (b, s, h, 128)
    pos = torch.arange(s, dtype=torch.int32, device=card).expand(b, s)
    ref = attend(q, k, v, pos, pos, window=0, causal=True)
    _close(out, ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,t,s,h,hkv,d,length,window", [
    (1, 1, 256, 4, 4, 128, 200, 0), (2, 5, 300, 8, 2, 64, 150, 0),
    (1, 17, 128, 4, 1, 64, 60, 16), (1, 9, 2048, 16, 16, 128, 700, 0),
    # a continuous batch's pass: GQA 32/8, each row at its own length
    (4, 5, 2048, 32, 8, 128, (261, 216, 155, 102), 0),
    # RecurrentGemma: MQA 16/1 at head_dim 256 and a window the context
    # outgrows, at B=1 and in a ragged batch
    (1, 5, 640, 16, 1, 256, 600, 256), (4, 33, 512, 16, 1, 256,
                                         (261, 216, 155, 102), 128),
    # StableLM-2 3B's head_dim 80; Minitron-4B's group of 3 (GQA 24/8)
    (1, 5, 2048, 32, 32, 80, 517, 0), (2, 1, 300, 6, 2, 80, 150, 24),
    (1, 5, 2048, 24, 8, 128, 517, 0), (3, 5, 512, 24, 8, 128,
                                       (261, 216, 155), 0),
    (1, 5, 2048, 32, 32, 64, 517, 0),
])
def test_decode_attention_kernel_matches_plain(card, dtype, b, t, s, h, hkv,
                                               d, length, window):
    gen = torch.Generator(device=card).manual_seed(s + t)
    q = _randn(gen, (b, t, h, d), dtype, card)
    kc = _randn(gen, (b, s, hkv, d), dtype, card)
    vc = _randn(gen, (b, s, hkv, d), dtype, card)
    cache_pos = torch.full((b, s), -1, dtype=torch.int32, device=card)
    q_pos = torch.empty((b, t), dtype=torch.int32, device=card)
    lengths = length if isinstance(length, tuple) else (length,) * b
    for r, n in enumerate(lengths):
        cache_pos[r, :n] = torch.arange(n, dtype=torch.int32, device=card)
        q_pos[r] = torch.arange(n - t, n, dtype=torch.int32, device=card)
    out = K.decode_attention(q, kc, vc, cache_pos, q_pos, window=window)
    torch.cuda.synchronize()
    _close(out, K.decode_attention_plain(q, kc, vc, cache_pos, q_pos,
                                         window=window), dtype)


def test_decode_attention_kernel_zero_rows(card):
    gen = torch.Generator(device=card).manual_seed(0)
    q = _randn(gen, (1, 3, 2, 64), torch.float32, card)
    kc = _randn(gen, (1, 64, 2, 64), torch.float32, card)
    cache_pos = torch.full((1, 64), -1, dtype=torch.int32, device=card)
    cache_pos[0, 40:44] = torch.arange(5, 9, dtype=torch.int32, device=card)
    q_pos = torch.tensor([[2, 6, 20]], dtype=torch.int32, device=card)
    out = K.decode_attention(q, kc, kc, cache_pos, q_pos)
    assert torch.equal(out[0, 0], torch.zeros_like(out[0, 0]))
    _close(out, K.decode_attention_plain(q, kc, kc, cache_pos, q_pos),
           torch.float32)


def _ring(b, s, t, lengths, dev):
    """cache_pos and q_pos of B rows that have written positions 0..n-1
    (n = lengths[r]) into an S-slot ring (slot = pos % S, so a row past S
    has wrapped), the span being the last T positions."""
    cache_pos = torch.full((b, s), -1, dtype=torch.int32, device=dev)
    q_pos = torch.empty((b, t), dtype=torch.int32, device=dev)
    for r, n in enumerate(lengths):
        pos = torch.arange(max(0, n - s), n, dtype=torch.int32, device=dev)
        cache_pos[r, (pos % s).long()] = pos
        q_pos[r] = torch.arange(n - t, n, dtype=torch.int32, device=dev)
    return cache_pos, q_pos


# The bf16 route on the tensor cores: one CTA serves all G*T queries of a
# KV head (G*T = 1, 5, 20, 80 and one past five 16-query tiles), every head
# dim, a ring that has wrapped with a window smaller than it (blocks wholly
# outside the window are skipped), splits of 16 to 128 slots, a ragged
# B = 4 batch, and a row whose ring is empty.
@pytest.mark.parametrize("b,t,s,h,hkv,d,lengths,window", [
    (1, 1, 2048, 16, 16, 128, (517,), 0),              # OLMoE, G*T = 1
    (1, 5, 2048, 16, 16, 128, (517,), 0),              # G*T = 5
    (1, 5, 2048, 32, 8, 128, (261,), 0),               # Mixtral, G*T = 20
    (4, 5, 2048, 32, 8, 128, (261, 216, 155, 102), 0),
    (1, 5, 3072, 16, 1, 256, (3001,), 2048),           # RecurrentGemma: 80
    (1, 1, 3072, 16, 1, 256, (3001,), 2048),
    (4, 5, 3072, 16, 1, 256, (3001, 2500, 700, 40), 2048),
    (1, 5, 256, 4, 1, 64, (600,), 128),                # wrapped ring
    (2, 3, 256, 8, 2, 128, (600, 300), 128),
    (1, 7, 512, 12, 1, 64, (400,), 0),                 # G*T = 84
    (2, 2, 96, 4, 2, 256, (0, 50), 0),                 # an empty row
    (1, 5, 2048, 32, 32, 80, (517,), 0),               # StableLM-2 3B
    (1, 1, 2048, 32, 32, 80, (517,), 0),
    (2, 5, 256, 8, 8, 80, (600, 300), 128),            # wrapped, windowed
    (1, 5, 2048, 24, 8, 128, (517,), 0),               # Minitron, G*T = 15
    (3, 5, 2048, 24, 8, 128, (261, 216, 20), 0),
    (1, 5, 2048, 32, 32, 64, (517,), 0),               # StableLM-2 1.6B
])
def test_decode_attention_mma_route_matches_plain(card, b, t, s, h, hkv, d,
                                                  lengths, window):
    gen = torch.Generator(device=card).manual_seed(s + t + d)
    q = _randn(gen, (b, t, h, d), torch.bfloat16, card)
    kc = _randn(gen, (b, s, hkv, d), torch.bfloat16, card)
    vc = _randn(gen, (b, s, hkv, d), torch.bfloat16, card)
    cache_pos, q_pos = _ring(b, s, t, lengths, card)
    assert decode_ops.route(torch.bfloat16) == "mma"
    n = K.decode_attention.launches_by_route["mma"]
    out = K.decode_attention(q, kc, vc, cache_pos, q_pos, window=window)
    again = K.decode_attention(q, kc, vc, cache_pos, q_pos, window=window)
    torch.cuda.synchronize()
    assert K.decode_attention.launches_by_route["mma"] == n + 2
    assert torch.equal(out, again)
    _close(out, K.decode_attention_plain(q, kc, vc, cache_pos, q_pos,
                                         window=window), torch.bfloat16)
    for r, n_r in enumerate(lengths):
        if n_r < t:  # queries at negative positions see no key: zeros
            assert not out[r, :t - n_r].any()


def test_decode_attention_mma_route_zero_rows_match_plain(card):
    gen = torch.Generator(device=card).manual_seed(1)
    q = _randn(gen, (1, 3, 2, 64), torch.bfloat16, card)
    kc = _randn(gen, (1, 64, 2, 64), torch.bfloat16, card)
    cache_pos = torch.full((1, 64), -1, dtype=torch.int32, device=card)
    cache_pos[0, 40:44] = torch.arange(5, 9, dtype=torch.int32, device=card)
    q_pos = torch.tensor([[2, 6, 20]], dtype=torch.int32, device=card)
    out = K.decode_attention(q, kc, kc, cache_pos, q_pos)
    assert torch.equal(out[0, 0], torch.zeros_like(out[0, 0]))
    _close(out, K.decode_attention_plain(q, kc, kc, cache_pos, q_pos),
           torch.bfloat16)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
@pytest.mark.parametrize("u,c,d,f", [(6, 5, 256, 128), (3, 40, 130, 70),
                                     (4, 17, 2048, 1024)])
def test_moe_gmm_fused_kernel_matches_plain(card, dtype, activation, u, c, d,
                                            f):
    gen = torch.Generator(device=card).manual_seed(u * c)
    counts = torch.randint(0, c + 1, (u,), generator=gen, device=card,
                           dtype=torch.int32)
    counts[0] = 0
    counts[-1] = c
    x = _randn(gen, (u, c, d), dtype, card)
    x[torch.arange(c, device=card)[None, :] >= counts[:, None]] = 0
    wg = _randn(gen, (u, d, f), dtype, card, d ** -0.5)
    wu = _randn(gen, (u, d, f), dtype, card, d ** -0.5)
    wd = _randn(gen, (u, f, d), dtype, card, f ** -0.5)
    out = K.moe_gmm_fused(x, wg, wu, wd, counts, activation=activation)
    torch.cuda.synchronize()
    _close(out, K.moe_gmm_fused_plain(x, wg, wu, wd, counts,
                                      activation=activation), dtype)
    assert torch.equal(out[0], torch.zeros_like(out[0]))


def test_moe_gmm_fused_kernel_is_deterministic_across_layouts(card):
    """The same expert rows give the same bits whether the slot sits in a
    dense [E,...] layout or a packed one naming it through expert_ids."""
    gen = torch.Generator(device=card).manual_seed(4)
    e, c, d, f = 8, 5, 512, 256
    counts = torch.tensor([0, 3, 0, 0, 5, 1, 0, 0], dtype=torch.int32,
                          device=card)
    x = _randn(gen, (e, c, d), torch.bfloat16, card)
    x[torch.arange(c, device=card)[None, :] >= counts[:, None]] = 0
    w1 = _randn(gen, (e, d, f), torch.bfloat16, card, d ** -0.5)
    w2 = _randn(gen, (e, d, f), torch.bfloat16, card, d ** -0.5)
    w3 = _randn(gen, (e, f, d), torch.bfloat16, card, f ** -0.5)
    dense = K.moe_gmm_fused(x, w1, w2, w3, counts)
    assert torch.equal(dense, K.moe_gmm_fused(x, w1, w2, w3, counts))
    ids = torch.tensor([1, 4, 5, 0], dtype=torch.int32, device=card)
    packed = K.moe_gmm_fused(x[ids.long()].contiguous(), w1, w2, w3,
                             counts[ids.long()].contiguous(), expert_ids=ids)
    assert torch.equal(packed, dense[ids.long()])


def test_moe_gmm_fused_kernel_expert_ids(card):
    gen = torch.Generator(device=card).manual_seed(3)
    e, u, c, d, f = 8, 4, 6, 256, 128
    ids = torch.tensor([5, 2, 7, 0], dtype=torch.int32, device=card)
    counts = torch.tensor([6, 1, 0, 3], dtype=torch.int32, device=card)
    x = _randn(gen, (u, c, d), torch.float32, card)
    w1 = _randn(gen, (e, d, f), torch.float32, card, d ** -0.5)
    w2 = _randn(gen, (e, d, f), torch.float32, card, d ** -0.5)
    w3 = _randn(gen, (e, f, d), torch.float32, card, f ** -0.5)
    out = K.moe_gmm_fused(x, w1, w2, w3, counts, expert_ids=ids)
    _close(out, K.moe_gmm_fused_plain(x, w1, w2, w3, counts, expert_ids=ids),
           torch.float32)


# The bf16 route on wgmma: prefill's C = 512 with counts 0, 1, 63, 64, 65
# and 512 (128-row token tiles, one to four a slot), verification spans C =
# 1, 5, 8 (8-row tiles) and 16 (16-row tiles), d and F multiples of 8 but
# not of 64 (TMA's zero fill), both activations.
@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
@pytest.mark.parametrize("c,d,f,counts", [
    (512, 512, 256, (0, 1, 63, 64, 65, 512)),
    (512, 2048, 1024, (64, 0, 70, 129)),
    (1, 2048, 1024, (1, 0, 1, 0, 0, 1)),
    (5, 2048, 1024, (5, 0, 3, 1, 5)),
    (8, 256, 128, (8, 7, 0)),
    (16, 2048, 1024, (16, 9, 0, 1)),
    (5, 200, 72, (5, 2, 0)),
    (40, 200, 72, (40, 17, 0)),
])
def test_moe_gmm_fused_wgmma_route_matches_plain(card, activation, c, d, f,
                                                 counts):
    gen = torch.Generator(device=card).manual_seed(c + d + f)
    u = len(counts)
    cnt = torch.tensor(counts, dtype=torch.int32, device=card)
    x = _randn(gen, (u, c, d), torch.bfloat16, card)
    x[torch.arange(c, device=card)[None, :] >= cnt[:, None]] = 0
    wg = _randn(gen, (u, d, f), torch.bfloat16, card, d ** -0.5)
    wu = _randn(gen, (u, d, f), torch.bfloat16, card, d ** -0.5)
    wd = _randn(gen, (u, f, d), torch.bfloat16, card, f ** -0.5)
    assert moe_ops.fused_route(torch.bfloat16, d, f) == "wgmma"
    n = K.moe_gmm_fused.launches_by_route["wgmma"]
    out = K.moe_gmm_fused(x, wg, wu, wd, cnt, activation=activation)
    again = K.moe_gmm_fused(x, wg, wu, wd, cnt, activation=activation)
    torch.cuda.synchronize()
    assert K.moe_gmm_fused.launches_by_route["wgmma"] == n + 2
    assert torch.equal(out, again)
    ref = K.moe_gmm_fused_plain(x, wg, wu, wd, cnt, activation=activation)
    _close(out, ref, torch.bfloat16)
    _moe_tol_check(out, ref)
    dead = torch.arange(c, device=card)[None, :] >= cnt[:, None]
    assert torch.equal(out[dead], torch.zeros_like(out[dead]))


@pytest.mark.parametrize("c", [1, 5, 16, 512])
def test_moe_gmm_fused_wgmma_route_layouts_match_plain(card, c):
    """expert_ids: a packed layout names its experts out of order, and each
    slot gives the bits it gives in the dense layout."""
    gen = torch.Generator(device=card).manual_seed(c)
    e, d, f = 8, 1024, 512
    cnt = torch.tensor([0, c, 0, 0, max(1, c // 2), 1, 0, 0],
                       dtype=torch.int32, device=card)
    x = _randn(gen, (e, c, d), torch.bfloat16, card)
    x[torch.arange(c, device=card)[None, :] >= cnt[:, None]] = 0
    w = [_randn(gen, shape, torch.bfloat16, card, shape[1] ** -0.5)
         for shape in ((e, d, f), (e, d, f), (e, f, d))]
    dense = K.moe_gmm_fused(x, *w, cnt)
    ids = torch.tensor([5, 1, 4, 0], dtype=torch.int32, device=card)
    xp, cp = x[ids.long()].contiguous(), cnt[ids.long()].contiguous()
    packed = K.moe_gmm_fused(xp, *w, cp, expert_ids=ids)
    torch.cuda.synchronize()
    assert torch.equal(packed, dense[ids.long()])
    _close(packed, K.moe_gmm_fused_plain(xp, *w, cp, expert_ids=ids),
           torch.bfloat16)


def _q8_experts(gen, e, d, f, dev):
    """Random int8 gate/up/down stacks and their float32 per-expert
    scales, quantized from float weights by the port's quantizer."""
    from repro_torch.kernels.moe_gmm.quant import quantize_int8
    out = []
    for shape, fan in (((e, d, f), d), ((e, d, f), d), ((e, f, d), f)):
        out.append(quantize_int8(_randn(gen, shape, torch.float32, dev,
                                        fan ** -0.5)))
    (wg, sg), (wu, su), (wd, sd) = out
    return wg, wu, wd, sg, su, sd


def _moe_tol_check(out, ref):
    """K1's and K4's tolerance: max |err| <= 1e-2 * max |ref| + 1e-3."""
    err = float((out.float() - ref.float()).abs().max())
    assert err <= 1e-2 * float(ref.float().abs().max()) + 1e-3, err


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
@pytest.mark.parametrize("u,c,d,f", [(6, 5, 256, 128), (3, 40, 144, 80),
                                     (4, 1, 2048, 1024), (2, 70, 512, 272)])
def test_moe_gmm_fused_quant_kernel_matches_plain(card, dtype, activation, u,
                                                  c, d, f):
    gen = torch.Generator(device=card).manual_seed(u * c + d)
    counts = torch.randint(0, c + 1, (u,), generator=gen, device=card,
                           dtype=torch.int32)
    counts[0] = 0
    counts[-1] = c
    x = _randn(gen, (u, c, d), dtype, card)
    x[torch.arange(c, device=card)[None, :] >= counts[:, None]] = 0
    wg, wu, wd, sg, su, sd = _q8_experts(gen, u, d, f, card)
    n = K.moe_gmm_fused_quant.launches
    out = K.moe_gmm_fused_quant(x, wg, wu, wd, sg, su, sd, counts,
                                activation=activation)
    torch.cuda.synchronize()
    assert K.moe_gmm_fused_quant.launches == n + 1
    ref = K.moe_gmm_fused_quant_plain(x, wg, wu, wd, sg, su, sd, counts,
                                      activation=activation)
    assert out.dtype == dtype
    if dtype == torch.float32:
        _close(out, ref, dtype)
    else:
        _moe_tol_check(out, ref)
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    live = torch.arange(c, device=card)[None, :] < counts[:, None]
    assert not out[~live].any()


def test_moe_gmm_fused_quant_kernel_is_deterministic_across_layouts(card):
    """The same expert rows give the same bits whether the slot sits in a
    dense [E,...] layout or a packed one naming it through expert_ids."""
    gen = torch.Generator(device=card).manual_seed(5)
    e, c, d, f = 8, 20, 512, 256
    counts = torch.tensor([0, 3, 0, 0, 9, 1, 0, 20], dtype=torch.int32,
                          device=card)
    x = _randn(gen, (e, c, d), torch.bfloat16, card)
    x[torch.arange(c, device=card)[None, :] >= counts[:, None]] = 0
    w = _q8_experts(gen, e, d, f, card)
    dense = K.moe_gmm_fused_quant(x, *w, counts)
    assert torch.equal(dense, K.moe_gmm_fused_quant(x, *w, counts))
    ids = torch.tensor([1, 4, 5, 7, 0], dtype=torch.int32, device=card)
    packed = K.moe_gmm_fused_quant(x[ids.long()].contiguous(), *w,
                                   counts[ids.long()].contiguous(),
                                   expert_ids=ids)
    assert torch.equal(packed, dense[ids.long()])


def test_moe_gmm_fused_quant_kernel_expert_ids(card):
    gen = torch.Generator(device=card).manual_seed(6)
    e, u, c, d, f = 8, 4, 6, 256, 128
    ids = torch.tensor([5, 2, 7, 0], dtype=torch.int32, device=card)
    counts = torch.tensor([6, 1, 0, 3], dtype=torch.int32, device=card)
    x = _randn(gen, (u, c, d), torch.float32, card)
    w = _q8_experts(gen, e, d, f, card)
    out = K.moe_gmm_fused_quant(x, *w, counts, expert_ids=ids)
    _close(out, K.moe_gmm_fused_quant_plain(x, *w, counts, expert_ids=ids),
           torch.float32)


def test_moe_gmm_fused_quant_refuses_bad_inputs(card):
    gen = torch.Generator(device=card).manual_seed(7)
    x = torch.zeros((2, 3, 32), device=card)
    counts = torch.ones(2, device=card, dtype=torch.int32)
    wg, wu, wd, sg, su, sd = _q8_experts(gen, 2, 32, 16, card)
    with pytest.raises(ValueError, match="int8"):
        K.moe_gmm_fused_quant(x, wg.float(), wu, wd, sg, su, sd, counts)
    with pytest.raises(ValueError, match="scales"):
        K.moe_gmm_fused_quant(x, wg, wu, wd, sg, su[:1], sd, counts)
    with pytest.raises(ValueError, match="int32"):
        K.moe_gmm_fused_quant(x, wg, wu, wd, sg, su, sd, counts.long())
    xo = torch.zeros((2, 3, 24), device=card)
    wo = torch.zeros((2, 24, 16), device=card, dtype=torch.int8)
    with pytest.raises(ValueError, match="multiples of 16"):
        K.moe_gmm_fused_quant(xo, wo, wo, wo.transpose(1, 2).contiguous(),
                              sg, su, sd, counts)


def _row_share(out, ref):
    """The worst row's share of K1's and K4's limit: max |err| of a row
    over 1e-2 * max |ref of the row| + 1e-3 (at most 1)."""
    o, r = out.float().flatten(0, -2), ref.float().flatten(0, -2)
    return float(((o - r).abs().amax(-1)
                  / (1e-2 * r.abs().amax(-1) + 1e-3)).max())


# The bf16 route on wgmma: every token tile (N = 8 at C = 2 and 5, 16 at C
# = 12, 32 at C = 20, 128 at C = 256 with one and three row tiles a slot),
# d and F multiples of 16 but not of 64 (TMA's zero fill), both
# activations, a dead slot and rows past the count.
@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
@pytest.mark.parametrize("c,d,f,counts", [
    (2, 1024, 512, (1, 0, 2)),
    (5, 1024, 512, (5, 0, 3, 1)),
    (12, 512, 256, (12, 0, 9)),
    (20, 1024, 512, (20, 0, 7, 1, 13)),
    (20, 144, 80, (20, 3, 0)),
    (256, 512, 256, (256, 0, 1, 64, 129)),
])
def test_moe_gmm_fused_quant_wgmma_route_matches_plain(card, activation, c,
                                                       d, f, counts):
    gen = torch.Generator(device=card).manual_seed(c + d + f)
    u = len(counts)
    cnt = torch.tensor(counts, dtype=torch.int32, device=card)
    x = _randn(gen, (u, c, d), torch.bfloat16, card)
    x[torch.arange(c, device=card)[None, :] >= cnt[:, None]] = 0
    w = _q8_experts(gen, u, d, f, card)
    assert moe_ops.quant_route(torch.bfloat16, d, f, c) == "wgmma"
    n = K.moe_gmm_fused_quant.launches_by_route["wgmma"]
    out = K.moe_gmm_fused_quant(x, *w, cnt, activation=activation)
    again = K.moe_gmm_fused_quant(x, *w, cnt, activation=activation)
    torch.cuda.synchronize()
    assert K.moe_gmm_fused_quant.launches_by_route["wgmma"] == n + 2
    assert torch.equal(out, again)
    ref = K.moe_gmm_fused_quant_plain(x, *w, cnt, activation=activation)
    _moe_tol_check(out, ref)
    assert _row_share(out, ref) <= 1.0
    dead = torch.arange(c, device=card)[None, :] >= cnt[:, None]
    assert torch.equal(out[dead], torch.zeros_like(out[dead]))


@pytest.mark.parametrize("c", [2, 20, 256])
def test_moe_gmm_fused_quant_wgmma_route_layouts_match_plain(card, c):
    """expert_ids: a packed layout names its experts out of order, and each
    slot gives the bits it gives in the dense layout."""
    gen = torch.Generator(device=card).manual_seed(100 + c)
    e, d, f = 8, 1024, 512
    cnt = torch.tensor([0, c, 0, 0, max(1, c // 2), 1, 0, 0],
                       dtype=torch.int32, device=card)
    x = _randn(gen, (e, c, d), torch.bfloat16, card)
    x[torch.arange(c, device=card)[None, :] >= cnt[:, None]] = 0
    w = _q8_experts(gen, e, d, f, card)
    dense = K.moe_gmm_fused_quant(x, *w, cnt)
    ids = torch.tensor([5, 1, 4, 0], dtype=torch.int32, device=card)
    xp, cp = x[ids.long()].contiguous(), cnt[ids.long()].contiguous()
    packed = K.moe_gmm_fused_quant(xp, *w, cp, expert_ids=ids)
    torch.cuda.synchronize()
    assert torch.equal(packed, dense[ids.long()])
    ref = K.moe_gmm_fused_quant_plain(xp, *w, cp, expert_ids=ids)
    _moe_tol_check(packed, ref)
    assert _row_share(packed, ref) <= 1.0


def test_moe_gmm_fused_quant_wgmma_route_at_mixtral_width(card):
    """Mixtral's d = 4096, F = 14336 at a B=4 pass's C = 20: h held at
    float32 precision keeps the worst row well inside its limit."""
    gen = torch.Generator(device=card).manual_seed(8)
    d, f = 4096, 14336
    cnt = torch.tensor([6, 0, 20], dtype=torch.int32, device=card)
    x = _randn(gen, (3, 20, d), torch.bfloat16, card)
    w = _q8_experts(gen, 3, d, f, card)
    out = K.moe_gmm_fused_quant(x, *w, cnt)
    ref = K.moe_gmm_fused_quant_plain(x, *w, cnt)
    _moe_tol_check(out, ref)
    assert _row_share(out, ref) <= 0.6


def test_moe_gmm_fused_quant_one_token_pass_takes_simt(card):
    """bf16 at C = 1 runs on the CUDA cores, h in float32."""
    gen = torch.Generator(device=card).manual_seed(10)
    cnt = torch.tensor([1, 0, 1], dtype=torch.int32, device=card)
    x = _randn(gen, (3, 1, 1024), torch.bfloat16, card)
    w = _q8_experts(gen, 3, 1024, 512, card)
    assert moe_ops.quant_route(torch.bfloat16, 1024, 512, 1) == "simt"
    before = dict(K.moe_gmm_fused_quant.launches_by_route)
    out = K.moe_gmm_fused_quant(x, *w, cnt)
    after = K.moe_gmm_fused_quant.launches_by_route
    assert after["simt"] == before["simt"] + 1
    assert after["wgmma"] == before["wgmma"]
    ref = K.moe_gmm_fused_quant_plain(x, *w, cnt)
    _moe_tol_check(out, ref)
    assert torch.equal(out[1], torch.zeros_like(out[1]))


def test_moe_gmm_fused_quant_float32_stays_on_simt(card):
    gen = torch.Generator(device=card).manual_seed(9)
    cnt = torch.tensor([5, 2], dtype=torch.int32, device=card)
    x = _randn(gen, (2, 5, 256), torch.float32, card)
    w = _q8_experts(gen, 2, 256, 128, card)
    assert moe_ops.quant_route(torch.float32, 256, 128, 5) == "simt"
    before = dict(K.moe_gmm_fused_quant.launches_by_route)
    out = K.moe_gmm_fused_quant(x, *w, cnt)
    after = K.moe_gmm_fused_quant.launches_by_route
    assert after["simt"] == before["simt"] + 1
    assert after["wgmma"] == before["wgmma"]
    _close(out, K.moe_gmm_fused_quant_plain(x, *w, cnt), torch.float32)


@pytest.mark.parametrize("window", [0, 16])
def test_flash_attention_f32_head_dim_48_matches_plain(card, window):
    """The reduced MLA configs' head_dim 48 (32 + 16 RoPE columns) on the
    float32 route, out and lse against the plain version; bf16 refuses
    it."""
    gen = torch.Generator(device=card).manual_seed(48 + window)
    q, k, v = (_randn(gen, (2, 70, 4, 48), torch.float32, card)
               for _ in range(3))
    out, lse = K.flash_attention(q, k, v, window=window, lse=True)
    ref, ref_lse = K.flash_attention_plain(q, k, v, window=window, lse=True)
    _close(out, ref, torch.float32)
    _close(lse, ref_lse, torch.float32)
    with pytest.raises(ValueError, match="head_dim"):
        K.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16())


def test_wrappers_refuse_bad_inputs(card):
    q = torch.zeros((1, 8, 2, 96), device=card)
    with pytest.raises(ValueError, match="head_dim"):
        K.flash_attention(q, q, q)
    q = torch.zeros((1, 8, 2, 64), device=card)
    with pytest.raises(ValueError, match="contiguous"):
        K.flash_attention(q.transpose(1, 2), q, q)
    with pytest.raises(ValueError, match="float32 or"):
        K.flash_attention(q.half(), q.half(), q.half())
    flat = torch.zeros(1 + q.numel(), device=card)
    with pytest.raises(ValueError, match="aligned"):
        K.flash_attention(flat[1:].view(q.shape), q, q)
    x = torch.zeros((2, 3, 8), device=card)
    w = torch.zeros((2, 8, 8), device=card)
    with pytest.raises(ValueError, match="int32"):
        K.moe_gmm_fused(x, w, w, w, torch.zeros(2, device=card,
                                                dtype=torch.int64))


def test_model_pass_on_card_matches_cpu(card):
    """A reduced float32 OLMoE pass on the card against the same pass on
    the CPU (plain versions), with the kernels launched."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = get_config("olmoe-1b-7b").reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    gparams = _to(params, card)
    toks = torch.tensor([[5, 9, 2, 7, 7, 1, 3, 8, 4]], dtype=torch.int32)
    span = torch.tensor([[3, 1, 4, 1, 5]], dtype=torch.int32)
    K.reset_launch_counts()
    outs = []
    for dev, p in (("cpu", params), (card, gparams)):
        cache = T.init_cache(cfg, 1, 64, device=dev)
        lo, cache, _ = T.prefill(cfg, p, toks.to(dev), cache)
        lo2, cache, aux, _ = T.decode_step(cfg, p, cache, span.to(dev),
                                           moe_packed=True)
        outs.append((lo.cpu(), lo2.cpu(), aux["unique_experts"].cpu()))
    counts = K.launch_counts()
    # a bf16/float32 model runs K1-K3; int8 experts (K4) are not on it
    assert all(counts[n] > 0 for n in ("flash_attention", "decode_attention",
                                       "moe_gmm_fused"))
    assert counts["moe_gmm_fused_quant"] == 0
    torch.testing.assert_close(outs[1][0], outs[0][0], atol=1e-3, rtol=1e-3)
    torch.testing.assert_close(outs[1][1], outs[0][1], atol=1e-3, rtol=1e-3)
    assert torch.equal(outs[1][2], outs[0][2])


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to(v, dev) for v in tree)
    return tree.to(dev)


def test_engine_spans_on_card_match_cpu(card):
    """ServingEngine on the card verifies real [1+K] spans (drafts, partial
    acceptance, rollback) and emits the CPU engine's greedy stream."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.controller import StaticKController
    from repro_torch.models import transformer as T
    from repro_torch.serving import NGramDrafter, ServingEngine

    cfg = get_config("olmoe-1b-7b").reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    pattern = np.random.default_rng(0).integers(3, cfg.vocab_size,
                                                16).tolist()
    prompt = [1] + pattern * 3
    runs = []
    for dev, p in (("cpu", params), ("cuda", _to(params, card))):
        eng = ServingEngine(cfg, p, NGramDrafter(),
                            controller_factory=lambda: StaticKController(4),
                            max_len=128, temperature=0.0, device=dev)
        runs.append(eng.generate(prompt, max_new=32))
    cpu, gpu = runs
    assert gpu.tokens == cpu.tokens
    its = gpu.telemetry.iterations
    assert sum(it.k_drafted for it in its) > 0
    assert any(it.tokens_emitted > 1 for it in its)


# --------------------------------------------------------------------- #
# The training path: K5 (moe_gmm), K3 with lse, their gradients
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("transpose_w", [False, True])
@pytest.mark.parametrize("e,c,d,f,counts", [
    (4, 37, 64, 96, (37, 0, 20, 64)),      # a count past C clamps to C
    (3, 70, 130, 70, (1, 69, 33)),         # rows not 16-byte multiples
    (2, 321, 256, 128, (321, 200)),        # OLMoE's odd C
    (5, 9, 17, 33, (9, 3, 0, 8, 1)),
])
def test_moe_gmm_kernel_matches_plain(card, dtype, transpose_w, e, c, d, f,
                                      counts):
    gen = torch.Generator(device=card).manual_seed(c + d)
    x = _randn(gen, (e, c, d), dtype, card)
    w = _randn(gen, (e, f, d) if transpose_w else (e, d, f), dtype, card,
               scale=d ** -0.5)
    cnt = torch.tensor(counts, dtype=torch.int32, device=card)
    n = K.moe_gmm.launches
    route = moe_ops.route(dtype, d, f)
    by_route = K.moe_gmm.launches_by_route[route]
    y = K.moe_gmm(x, w, cnt, transpose_w=transpose_w)
    torch.cuda.synchronize()
    assert K.moe_gmm.launches == n + 1
    assert K.moe_gmm.launches_by_route[route] == by_route + 1
    assert y.shape == (e, c, f) and y.dtype == dtype
    _close(y, K.moe_gmm_plain(x, w, cnt, transpose_w=transpose_w), dtype)
    dead = torch.arange(c, device=card)[None, :] >= cnt[:, None]
    assert torch.equal(y[dead], torch.zeros_like(y[dead]))


# The bf16 wgmma route: OLMoE's C = 321 with counts 0, 1, 64, 65 and past
# C, widths at full size, d and F multiples of 8 but not of 64 (TMA's zero
# fill on K and N), and clusters of row tiles with dead members.
@pytest.mark.parametrize("transpose_w", [False, True])
@pytest.mark.parametrize("e,c,d,f,counts", [
    (5, 321, 2048, 1024, (0, 1, 64, 65, 400)),
    (5, 321, 1024, 2048, (321, 65, 64, 1, 0)),
    (3, 321, 200, 72, (321, 129, 65)),
    (2, 70, 72, 200, (70, 8)),
    # 5 row tiles: a cluster of 4 and a padded one, live tiles 5, 3 and 0
    (3, 600, 64, 264, (600, 300, 0)),
])
def test_moe_gmm_wgmma_route_matches_plain(card, transpose_w, e, c, d, f,
                                           counts):
    gen = torch.Generator(device=card).manual_seed(c + d + f)
    x = _randn(gen, (e, c, d), torch.bfloat16, card)
    w = _randn(gen, (e, f, d) if transpose_w else (e, d, f), torch.bfloat16,
               card, scale=d ** -0.5)
    cnt = torch.tensor(counts, dtype=torch.int32, device=card)
    n = K.moe_gmm.launches_by_route["wgmma"]
    y = K.moe_gmm(x, w, cnt, transpose_w=transpose_w)
    again = K.moe_gmm(x, w, cnt, transpose_w=transpose_w)
    torch.cuda.synchronize()
    assert K.moe_gmm.launches_by_route["wgmma"] == n + 2
    _close(y, K.moe_gmm_plain(x, w, cnt, transpose_w=transpose_w),
           torch.bfloat16)
    dead = torch.arange(c, device=card)[None, :] >= cnt[:, None]
    assert torch.equal(y[dead], torch.zeros_like(y[dead]))
    assert torch.equal(y, again)


@pytest.mark.parametrize("dtype", DTYPES)
def test_moe_gmm_autograd_on_card_matches_plain(card, dtype):
    """MoeGmm's dx (the kernel, transposed) and dw (bmm) against autograd
    through the plain version."""
    gen = torch.Generator(device=card).manual_seed(3)
    e, c, d, f = 4, 45, 96, 80
    cnt = torch.tensor([45, 0, 17, 30], dtype=torch.int32, device=card)
    x0 = _randn(gen, (e, c, d), dtype, card)
    w0 = _randn(gen, (e, d, f), dtype, card, scale=d ** -0.5)
    dy = _randn(gen, (e, c, f), dtype, card)
    grads = []
    for fn in (lambda x, w: K.MoeGmm.apply(x, w, cnt),
               lambda x, w: K.moe_gmm_plain(x, w, cnt)):
        x, w = (t.clone().requires_grad_() for t in (x0, w0))
        (fn(x, w).float() * dy.float()).sum().backward()
        grads.append((x.grad, w.grad))
    for got, ref in zip(*grads):
        _close(got, ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s,h,hkv,d,window", [
    (2, 77, 4, 2, 64, 0), (1, 130, 4, 4, 128, 24),
])
def test_flash_attention_lse_and_grads_on_card_match_plain(
        card, dtype, b, s, h, hkv, d, window):
    gen = torch.Generator(device=card).manual_seed(s)
    q0 = _randn(gen, (b, s, h, d), dtype, card)
    k0 = _randn(gen, (b, s, hkv, d), dtype, card)
    v0 = _randn(gen, (b, s, hkv, d), dtype, card)
    do = _randn(gen, (b, s, h, d), dtype, card)
    out, lse = K.flash_attention(q0, k0, v0, window=window, lse=True)
    torch.cuda.synchronize()
    ref_out, ref_lse = K.flash_attention_plain(q0, k0, v0, window=window,
                                               lse=True)
    _close(out, ref_out, dtype)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)
    grads = []
    for fn in (lambda q, k, v: K.FlashAttention.apply(q, k, v, window),
               lambda q, k, v: K.flash_attention_plain(q, k, v,
                                                       window=window)):
        q, k, v = (t.clone().requires_grad_() for t in (q0, k0, v0))
        (fn(q, k, v).float() * do.float()).sum().backward()
        grads.append((q.grad, k.grad, v.grad))
    for got, ref in zip(*grads):
        _close(got, ref, dtype)


def test_moe_gmm_refuses_bad_inputs(card):
    x = torch.zeros((2, 3, 8), device=card)
    w = torch.zeros((2, 8, 4), device=card)
    cnt = torch.ones(2, device=card, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        K.moe_gmm(x, w, cnt.long())
    with pytest.raises(ValueError, match="float32 or"):
        K.moe_gmm(x, w.bfloat16(), cnt)
    with pytest.raises(ValueError, match="do not match"):
        K.moe_gmm(x, w, cnt, transpose_w=True)
    with pytest.raises(ValueError, match="CUDA"):
        K.moe_gmm(x, w.cpu(), cnt)


def test_train_step_on_card_matches_cpu(card):
    """The reduced float32 OLMoE's loss gradients on the card (K5, K3 with
    lse) against the CPU's (plain versions), and two AdamW steps' metrics.
    (Updated parameters are not compared: AdamW's first steps move each
    weight by about lr * sign(g), and gradients at float noise may flip.)"""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data import batch_iterator
    from repro_torch.models import transformer as T
    from repro_torch.training import adamw, loss_fn, make_train_step
    from repro_torch.training.optimizer import tree_leaves, tree_map

    cfg = get_config("olmoe-1b-7b").reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    batches = [next(batch_iterator("all-3", 2, 48, vocab=cfg.vocab_size,
                                   seed=i, prompt_len=16)) for i in range(2)]
    K.reset_launch_counts()
    runs = []
    for dev, p in (("cpu", params), (card, _to(params, card))):
        live = [t.detach().requires_grad_() for t in tree_leaves(p)]
        it = iter(live)
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in batches[0].items()}
        loss, _ = loss_fn(cfg, tree_map(lambda _: next(it), p), batch)
        grads = torch.autograd.grad(loss, live)
        opt = adamw(1e-3)
        _, step = make_train_step(cfg, optimizer=opt)
        state = (p, opt.init(p))
        ms = []
        for b in batches:
            state, m = step(state, b)
            ms.append({k: float(v) for k, v in m.items()})
        runs.append((ms, [g.cpu() for g in grads]))
    counts = K.launch_counts()
    assert counts["moe_gmm"] > 0 and counts["flash_attention"] > 0
    (cm, cg), (gm, gg) = runs
    for a, b in zip(gm, cm):
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-5)
    for g, c in zip(gg, cg):
        torch.testing.assert_close(g, c, rtol=1e-3, atol=1e-4 * max(
            float(c.abs().max()), 1e-6))



# --------------------------------------------------------------------- #
# The RWKV-6 path: K6 (rwkv_scan), staged states, rollback
# --------------------------------------------------------------------- #

def _scan_inputs(gen, dev, b, t, h, n):
    r, k, v = (_randn(gen, (b, t, h, n), torch.float32, dev)
               for _ in range(3))
    w = torch.exp(-torch.exp(_randn(gen, (b, t, h, n), torch.float32, dev)
                             - 1.0))
    u = _randn(gen, (h, n), torch.float32, dev, scale=0.5)
    s0 = _randn(gen, (b, h, n, n), torch.float32, dev)
    return r, k, v, w, u, s0


def _scan_close(out, ref):
    """|err| <= 1e-4 * max|ref| + 1e-6: float32 sums of N products in
    another order, fused multiply-adds on the card."""
    lim = 1e-4 * float(ref.abs().max()) + 1e-6
    err = float((out - ref).abs().max())
    assert err <= lim, (err, lim)


@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("b,t,h,n", [
    (1, 5, 40, 64), (4, 5, 40, 64), (1, 1, 40, 64), (1, 512, 40, 64),
    (4, 32, 40, 64), (3, 33, 8, 32), (2, 17, 3, 64), (1, 7, 8, 32),
])
def test_rwkv_scan_kernel_matches_plain(card, staged, b, t, h, n):
    """The path's shapes (prefill 512, the [1+4] span at B=1 and B=4, a
    1-token pass, the batched engine's chunk pass of 32 at B=4) and odd T
    at both head sizes: y, s_last and every staged state."""
    gen = torch.Generator(device=card).manual_seed(b * 1000 + t)
    args = _scan_inputs(gen, card, b, t, h, n)
    states = (torch.full((t + 1, b, h, n, n), float("nan"), device=card)
              if staged else None)
    ref_states = torch.empty_like(states) if staged else None
    n0 = K.rwkv_scan.launches
    y, s_last = K.rwkv_scan(*args, states=states)
    torch.cuda.synchronize()
    assert K.rwkv_scan.launches == n0 + 1
    ry, rs = K.rwkv_scan_plain(*args, states=ref_states)
    _scan_close(y, ry)
    _scan_close(s_last, rs)
    if staged:
        assert torch.equal(states[0], args[5])
        for j in range(1, t + 1):
            _scan_close(states[j], ref_states[j])


def _slices_close(out, ref, rows):
    """Per (row, head) slice (viewed as [rows, -1]): max|err| <=
    1e-3 * max|ref of the slice| + 1e-6, the chip check's limit."""
    g, c = out.reshape(rows, -1), ref.reshape(rows, -1)
    lim = 1e-3 * c.abs().amax(1) + 1e-6
    assert bool(((g - c).abs().amax(1) <= lim).all())


@pytest.mark.parametrize("n", [32, 64])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("t", [31, 32, 33, 67, 512])
def test_rwkv_scan_chunked_route_matches_plain(card, n, b, t):
    """Calls without staged states around the chunk length (CHUNK - 1,
    CHUNK, CHUNK + 1, 2 CHUNK + 3) and at the prefill's 512, from a state
    s0 != 0: more than CHUNK tokens take the chunked route (counted by
    route), and y and s_last agree with the plain version per (row, head)
    slice."""
    from repro_torch.kernels.rwkv_scan import ops as rwkv_ops

    assert rwkv_ops.CHUNK == 32
    gen = torch.Generator(device=card).manual_seed(100 * t + 10 * b + n)
    args = _scan_inputs(gen, card, b, t, 8, n)
    assert bool(args[5].abs().amax() > 0)
    route = rwkv_ops.route(t, False)
    assert route == ("chunked" if t > rwkv_ops.CHUNK else "serial")
    n0 = dict(K.rwkv_scan.launches_by_route)
    y, s_last = K.rwkv_scan(*args)
    torch.cuda.synchronize()
    assert K.rwkv_scan.launches_by_route[route] == n0[route] + 1
    ry, rs = K.rwkv_scan_plain(*args)
    _scan_close(y, ry)
    _scan_close(s_last, rs)
    _slices_close(y.transpose(1, 2), ry.transpose(1, 2), b * 8)
    _slices_close(s_last, rs, b * 8)


def test_rwkv_scan_refuses_bad_inputs(card):
    args = _scan_inputs(torch.Generator(device=card).manual_seed(0), card,
                        1, 3, 2, 64)
    r, k, v, w, u, s0 = args
    with pytest.raises(ValueError, match="float32"):
        K.rwkv_scan(r.bfloat16(), k, v, w, u, s0)
    with pytest.raises(ValueError, match="contiguous"):
        K.rwkv_scan(r.transpose(1, 2), k, v, w, u, s0)
    with pytest.raises(ValueError, match="CUDA"):
        K.rwkv_scan(r, k, v, w, u.cpu(), s0)
    with pytest.raises(ValueError, match="do not match"):
        K.rwkv_scan(r, k, v, w, u, s0[:, :1])
    with pytest.raises(ValueError, match="do not match"):
        K.rwkv_scan(r, k, v, w, u, s0,
                    states=torch.empty((3, 1, 2, 64, 64), device=card))
    a48 = _scan_inputs(torch.Generator(device=card).manual_seed(1), card,
                       1, 3, 2, 48)
    with pytest.raises(ValueError, match="head size"):
        K.rwkv_scan(*a48)


@pytest.mark.parametrize("b,t,h,n", [
    (1, 512, 40, 64), (4, 32, 40, 64), (1, 1, 40, 64), (2, 33, 8, 32),
    (1, 67, 3, 64), (3, 5, 8, 32),
])
def test_rwkv_scan_bwd_kernel_matches_plain(card, b, t, h, n):
    """K6b at the training shapes (RWKV-6-3B's [1,512] and [4,32] calls)
    and odd T at both head sizes, from the forward's chunk checkpoints
    (the chunked route's past 32 tokens, s0 up to 32), with seeded output
    gradients for y and the last state: each of dr, dk, dv, dw, du and
    ds0 within 1e-4 * max|ref| + 1e-6 of the plain version; the same
    through `RwkvScan`'s backward."""
    gen = torch.Generator(device=card).manual_seed(b * 1000 + t + n)
    args = _scan_inputs(gen, card, b, t, h, n)
    dy = _randn(gen, (b, t, h, n), torch.float32, card)
    ds = _randn(gen, (b, h, n, n), torch.float32, card)
    _, _, ckpt = K.rwkv_scan(*args, checkpoints=True)
    assert ckpt.shape == (b, h, -(-t // 32), n, n)
    assert torch.equal(ckpt[:, :, 0], args[5])
    n0 = K.rwkv_scan_bwd.launches
    got = K.rwkv_scan_bwd(*args, dy, ds, ckpt=ckpt)
    torch.cuda.synchronize()
    assert K.rwkv_scan_bwd.launches == n0 + 1
    ref = K.rwkv_scan_bwd_plain(*args, dy, ds)
    for g, r in zip(got, ref):
        _scan_close(g, r)
    leaves = [a.clone().requires_grad_() for a in args]
    auto = torch.autograd.grad(K.RwkvScan.apply(*leaves), leaves, (dy, ds))
    assert K.rwkv_scan_bwd.launches == n0 + 2
    for g, r in zip(auto, ref):
        _scan_close(g, r)


def test_rwkv_scan_bwd_refuses_bad_inputs(card):
    gen = torch.Generator(device=card).manual_seed(0)
    r, k, v, w, u, s0 = _scan_inputs(gen, card, 1, 40, 2, 64)
    dy = torch.ones_like(r)
    with pytest.raises(ValueError, match="checkpoints"):
        K.rwkv_scan_bwd(r, k, v, w, u, s0, dy)
    _, _, ckpt = K.rwkv_scan(r, k, v, w, u, s0, checkpoints=True)
    with pytest.raises(ValueError, match="float32"):
        K.rwkv_scan_bwd(r, k, v, w, u, s0, dy.bfloat16(), ckpt=ckpt)
    with pytest.raises(ValueError, match="contiguous"):
        K.rwkv_scan_bwd(r, k, v, w, u, s0, dy.transpose(1, 2).contiguous()
                        .transpose(1, 2), ckpt=ckpt)
    with pytest.raises(ValueError, match="CUDA"):
        K.rwkv_scan_bwd(r, k, v, w, u.cpu(), s0, dy, ckpt=ckpt)
    with pytest.raises(ValueError, match="do not match"):
        K.rwkv_scan_bwd(r, k, v, w, u, s0, dy,
                        ckpt=ckpt[:, :, :1].contiguous())
    with pytest.raises(ValueError, match="do not match"):
        K.rwkv_scan_bwd(r, k, v, w, u, s0, dy, s0[:, :1].contiguous(),
                        ckpt=ckpt)
    a48 = _scan_inputs(gen, card, 1, 3, 2, 48)
    with pytest.raises(ValueError, match="head size"):
        K.rwkv_scan_bwd(*a48, torch.ones_like(a48[0]),
                        ckpt=a48[5][:, :, None].contiguous())


def test_rwkv_pass_span_and_rollback_on_card_match_cpu(card):
    """A 2-layer float32 RWKV-6 at full width (d=2560, 40 heads of 64) on
    the card against the CPU: prefill, a [1+4] span with staged states, a
    rollback to 2 accepted and the re-verified tokens; K6 launched once
    per layer per pass."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_config("rwkv6-3b"), num_layers=2,
                              dtype="float32", vocab_size=512)
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    toks = torch.randint(0, 512, (1, 24), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))
    K.reset_launch_counts()
    runs = []
    for dev, p in (("cpu", params), (card, _to(params, card))):
        cache = T.init_cache(cfg, 1, 64, device=dev)
        lo, cache, _ = T.prefill(cfg, p, toks[:, :17].to(dev), cache)
        lo2, c2, _, st = T.decode_step(cfg, p, cache, toks[:, 17:22].to(dev))
        c3 = T.rollback_cache(cfg, c2, st, 2, 17)
        assert torch.equal(c3["wkv"], st["wkv"][:, 2])
        lo3, _, _, _ = T.decode_step(cfg, p, c3, toks[:, 19:22].to(dev))
        runs.append([x.cpu() for x in (lo, lo2, lo3, c3["wkv"],
                                       c3["sx_att"], st["wkv"])])
    assert K.rwkv_scan.launches == 3 * cfg.num_layers
    for g, c in zip(runs[1], runs[0]):
        torch.testing.assert_close(g, c, atol=1e-3 * float(c.abs().max()),
                                   rtol=1e-3)
    # the re-verified tokens see the state the span left after 2 tokens
    torch.testing.assert_close(runs[1][2], runs[1][1][:, 2:], rtol=1e-3,
                               atol=1e-3 * float(runs[1][1].abs().max()))


# --------------------------------------------------------------------- #
# The RecurrentGemma path: K7 (linear_scan), K2/K3 at head_dim 256
# --------------------------------------------------------------------- #

def _linear_scan_inputs(gen, dev, b, t, d):
    """a in (0, 1) as the RG-LRU makes it, x ~ N(0, 1), h0 ~ N(0, 1)."""
    a = torch.sigmoid(_randn(gen, (b, t, d), torch.float32, dev) + 3.0)
    x = _randn(gen, (b, t, d), torch.float32, dev)
    h0 = _randn(gen, (b, d), torch.float32, dev)
    return a, x, h0


@pytest.mark.parametrize("b,t,d", [
    (1, 5, 4096), (4, 5, 4096), (1, 1, 4096), (4, 32, 4096), (4, 33, 4096),
    (1, 64, 4096), (1, 65, 4096), (1, 3000, 4096), (2, 37, 1000),
    (3, 130, 77),
])
def test_linear_scan_kernel_matches_plain(card, b, t, d):
    """The path's shapes (the [1+4] span at B=1 and B=4, a 1-token pass,
    the batched engine's chunk of 32 and 33 staged tokens, a prefill longer
    than the 2048 window) and odd T and D. Every channel is walked in
    order with the plain loop's roundings, so y and h_last are equal bit
    for bit at every T."""
    gen = torch.Generator(device=card).manual_seed(b * 10000 + t + d)
    a, x, h0 = _linear_scan_inputs(gen, card, b, t, d)
    n0 = K.linear_scan.launches
    y, h_last = K.linear_scan(a, x, h0)
    torch.cuda.synchronize()
    assert K.linear_scan.launches == n0 + 1
    ry, rh = K.linear_scan_plain(a, x, h0)
    assert torch.equal(y, ry) and torch.equal(h_last, rh)
    assert torch.equal(h_last, y[:, -1])


@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("d", [77, 1000, 4096])
@pytest.mark.parametrize("t", [1, 5, 63, 64, 65, 130, 3000])
def test_linear_scan_kernel_bit_equal_to_plain(card, b, t, d):
    """Bit-equal to the plain loop across token counts around a stage of
    the ring (32 tokens) and past its depth, at widths that do not fill a
    warp's 32 channels and one (D = 77) whose rows are not 16-byte
    multiples."""
    gen = torch.Generator(device=card).manual_seed(7 * t + 3 * d + b)
    a, x, h0 = _linear_scan_inputs(gen, card, b, t, d)
    y, h_last = K.linear_scan(a, x, h0)
    ry, rh = K.linear_scan_plain(a, x, h0)
    assert torch.equal(y, ry) and torch.equal(h_last, rh)


def test_linear_scan_refuses_bad_inputs(card):
    a, x, h0 = _linear_scan_inputs(torch.Generator(device=card).manual_seed(0),
                                   card, 2, 7, 64)
    with pytest.raises(ValueError, match="float32"):
        K.linear_scan(a.bfloat16(), x, h0)
    with pytest.raises(ValueError, match="contiguous"):
        K.linear_scan(a.transpose(0, 1), x.transpose(0, 1), h0)
    with pytest.raises(ValueError, match="CUDA"):
        K.linear_scan(a, x, h0.cpu())
    with pytest.raises(ValueError, match="do not match"):
        K.linear_scan(a, x, h0[:1])


@pytest.mark.parametrize("b,t,d", [
    (1, 512, 4096), (4, 32, 4096), (1, 1, 4096), (2, 37, 1000), (3, 130, 77),
])
def test_linear_scan_bwd_kernel_bit_equal_to_plain(card, b, t, d):
    """K7b at the training shapes (RecurrentGemma-9B's [1,512] and [4,32]
    calls) and odd T and D: da, dx and dh0 equal to the plain version bit
    for bit (each step a product, then a sum, in the same order), with and
    without a gradient for h_last; the same through `LinearScan`."""
    gen = torch.Generator(device=card).manual_seed(b * 10000 + t + d)
    a, x, h0 = _linear_scan_inputs(gen, card, b, t, d)
    y, _ = K.linear_scan(a, x, h0)
    dy = _randn(gen, (b, t, d), torch.float32, card)
    dh = _randn(gen, (b, d), torch.float32, card)
    for dh_last in (dh, None):
        n0 = K.linear_scan_bwd.launches
        got = K.linear_scan_bwd(a, y, h0, dy, dh_last)
        torch.cuda.synchronize()
        assert K.linear_scan_bwd.launches == n0 + 1
        ref = K.linear_scan_bwd_plain(a, y, h0, dy, dh_last)
        assert all(torch.equal(g, r) for g, r in zip(got, ref))
    leaves = [z.clone().requires_grad_() for z in (a, x, h0)]
    auto = torch.autograd.grad(K.LinearScan.apply(*leaves), leaves,
                               (dy, dh))
    ref = K.linear_scan_bwd_plain(a, y, h0, dy, dh)
    assert all(torch.equal(g, r) for g, r in zip(auto, ref))


def test_linear_scan_bwd_refuses_bad_inputs(card):
    a, x, h0 = _linear_scan_inputs(torch.Generator(device=card).manual_seed(0),
                                   card, 2, 7, 64)
    y, dy = x.clone(), torch.ones_like(x)
    with pytest.raises(ValueError, match="float32"):
        K.linear_scan_bwd(a, y, h0, dy.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        K.linear_scan_bwd(a.transpose(0, 1), y.transpose(0, 1), h0,
                          dy.transpose(0, 1))
    with pytest.raises(ValueError, match="CUDA"):
        K.linear_scan_bwd(a, y, h0.cpu(), dy)
    with pytest.raises(ValueError, match="do not match"):
        K.linear_scan_bwd(a, y, h0, dy, h0[:1])


def test_recurrentgemma_pass_on_card_matches_cpu(card):
    """A 3-layer float32 RecurrentGemma ("RRA", d = d_rnn = 1024, MQA 4/1
    at head_dim 256, local window 32) on the card against the CPU: a
    prefill past the window, a [1+4] span with staged h and conv, a
    rollback to 2 and the re-verified tokens; K7 launched once per "R"
    layer per pass, K2 and K3 once per "A" layer."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_config("recurrentgemma-9b").reduced(),
                              d_model=1024, d_rnn=1024, num_heads=4,
                              num_kv_heads=1, head_dim=256, d_ff=2048)
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (1, 52), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))
    K.reset_launch_counts()
    runs = []
    for dev, p in (("cpu", params), (card, _to(params, card))):
        cache = T.init_cache(cfg, 1, 64, device=dev)
        lo, cache, _ = T.prefill(cfg, p, toks[:, :45].to(dev), cache)
        lo2, c2, _, st = T.decode_step(cfg, p, cache, toks[:, 45:50].to(dev))
        c3 = T.rollback_cache(cfg, c2, st, 2, 45)
        assert torch.equal(c3["h"], st["h"][:, 2])
        assert torch.equal(c3["conv"], st["conv"][:, 2])
        lo3, _, _, _ = T.decode_step(cfg, p, c3, toks[:, 47:50].to(dev))
        runs.append([t.cpu() for t in (lo, lo2, lo3, c3["h"], c3["conv"],
                                       st["h"], st["conv"])])
    counts = K.launch_counts()
    assert counts["linear_scan"] == 3 * 2
    assert counts["flash_attention"] == 1
    assert counts["decode_attention"] == 2
    for g, c in zip(runs[1], runs[0]):
        torch.testing.assert_close(g, c, atol=1e-3 * float(c.abs().max()),
                                   rtol=1e-3)
    # the re-verified tokens see the state the span left after 2 tokens
    torch.testing.assert_close(runs[1][2], runs[1][1][:, 2:], rtol=1e-3,
                               atol=1e-3 * float(runs[1][1].abs().max()))


def test_moe_pattern_stack_pass_on_card_matches_cpu(card):
    """The 3-layer float32 RecurrentGemma of the test above with a MoE (8
    experts, top-2, F=512) in place of its "A" layer's FFN, on the card
    against the CPU: a prefill past the window, a [1+4] span, a rollback
    to 2 and the re-verified tokens; the aux empty on both (the pattern
    loop drops the routing); K7 once per "R" layer per pass, K1, K2 and
    K3 as the "A" layer's MoE and attention."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_config("recurrentgemma-9b").reduced(),
                              d_model=1024, d_rnn=1024, num_heads=4,
                              num_kv_heads=1, head_dim=256, d_ff=2048,
                              num_experts=8, experts_per_token=2,
                              moe_d_ff=512)
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    assert "moe" in params["blocks_list"][2]
    toks = torch.randint(0, cfg.vocab_size, (1, 52), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))
    K.reset_launch_counts()
    runs = []
    for dev, p in (("cpu", params), (card, _to(params, card))):
        cache = T.init_cache(cfg, 1, 64, device=dev)
        lo, cache, aux = T.prefill(cfg, p, toks[:, :45].to(dev), cache)
        assert aux == {}
        lo2, c2, aux, st = T.decode_step(cfg, p, cache,
                                         toks[:, 45:50].to(dev))
        assert aux == {}
        c3 = T.rollback_cache(cfg, c2, st, 2, 45)
        lo3, _, _, _ = T.decode_step(cfg, p, c3, toks[:, 47:50].to(dev))
        runs.append([t.cpu() for t in (lo, lo2, lo3, c3["h"], c3["conv"],
                                       st["h"], st["conv"])])
    counts = K.launch_counts()
    assert counts["linear_scan"] == 3 * 2
    assert counts["moe_gmm_fused"] == 3
    assert counts["flash_attention"] == 1
    assert counts["decode_attention"] == 2
    for g, c in zip(runs[1], runs[0]):
        torch.testing.assert_close(g, c, atol=1e-3 * float(c.abs().max()),
                                   rtol=1e-3)
