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
])
def test_flash_attention_kernel_matches_plain(card, dtype, b, s, h, hkv, d,
                                              window):
    gen = torch.Generator(device=card).manual_seed(s)
    q = _randn(gen, (b, s, h, d), dtype, card)
    k = _randn(gen, (b, s, hkv, d), dtype, card)
    v = _randn(gen, (b, s, hkv, d), dtype, card)
    n = K.flash_attention.launches
    out = K.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert K.flash_attention.launches == n + 1
    _close(out, K.flash_attention_plain(q, k, v, window=window), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,t,s,h,hkv,d,length,window", [
    (1, 1, 256, 4, 4, 128, 200, 0), (2, 5, 300, 8, 2, 64, 150, 0),
    (1, 17, 128, 4, 1, 64, 60, 16), (1, 9, 2048, 16, 16, 128, 700, 0),
])
def test_decode_attention_kernel_matches_plain(card, dtype, b, t, s, h, hkv,
                                               d, length, window):
    gen = torch.Generator(device=card).manual_seed(s + t)
    q = _randn(gen, (b, t, h, d), dtype, card)
    kc = _randn(gen, (b, s, hkv, d), dtype, card)
    vc = _randn(gen, (b, s, hkv, d), dtype, card)
    cache_pos = torch.full((b, s), -1, dtype=torch.int32, device=card)
    cache_pos[:, :length] = torch.arange(length, dtype=torch.int32,
                                         device=card)
    q_pos = (length - t + torch.arange(t, dtype=torch.int32, device=card)
             ).expand(b, t).contiguous()
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
    assert all(n > 0 for n in K.launch_counts().values())
    torch.testing.assert_close(outs[1][0], outs[0][0], atol=1e-3, rtol=1e-3)
    torch.testing.assert_close(outs[1][1], outs[0][1], atol=1e-3, rtol=1e-3)
    assert torch.equal(outs[1][2], outs[0][2])


def _to(tree, dev):
    return {k: (_to(v, dev) if isinstance(v, dict) else v.to(dev))
            for k, v in tree.items()}


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
