"""ChatGLM3-6B (2-D RoPE), Qwen2-VL-7B (M-RoPE over precomputed
embeddings) and Whisper-large-v3 (cross-attention to encoder states) in
the port against the JAX package on the CPU, at `.reduced()` sizes in
float32, with one prompt length.

- Ops at 1e-6: `apply_rope_2d`, `apply_mrope` (and M-RoPE's text-only
  broadcast of [B,S] positions) and `_sinusoid` at atol 1e-6;
  `encode_cross_kv` and `cross_attention` (on the CPU,
  `decode_attention`'s plain version with every key and query at
  position 0) within 1e-6 * max|ref|: two float32 matmuls of 256-long
  rows sum in different orders, a few ulps apart at |ref| ~ 4.
- Per arch, the counterpart of the reference's
  `test_decode_matches_full_forward_and_rollback`: a 12-token prefill, a
  3-token pass, a rollback keeping 1, a 2-token pass, and the full
  forward as oracle; logits within atol 1e-5 of the JAX package's, the
  cache's `pos` and `length` exactly; the `enc_k`/`enc_v` leaves exactly
  the port's `encode_cross_kv` of the encoder output, untouched by the
  passes and the rollback, and within 1e-6 * max|ref| of the JAX
  package's (matmul order, as above).
- Qwen2-VL's `prefill(embeds=, rope_pos=)` over a 4x4 patch grid and text,
  then a `decode_step`, within atol 1e-5.
- `train_forward(embeds=, rope_pos=)`'s logits (atol 1e-5) and the loss's
  gradients (max|err| <= 1e-5 * max|ref| + 1e-7 per leaf) against
  `jax.grad`; Whisper's `loss_fn` with `enc_out` (cross-attention through
  `CrossAttention`: the plain decode attention forward, the unmasked
  attention backward) and every gradient against
  `jax.value_and_grad`, on the same terms (`assert_loss_and_grads`, which
  the RWKV-6, RecurrentGemma and MLA files use too).
- `ServingEngine` and `BatchedEngine(max_batch=2, chunk=8)` on Whisper
  (one encoder output per request: the blocking fallback) and ChatGLM:
  token streams and model-clock telemetry exactly equal to the JAX
  engines'."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.controller import CascadeController as JCascade
from repro.models import attention as jattn
from repro.models import rope as jrope
from repro.models import transformer as jT
from repro.serving import NGramDrafter as JNGram
from repro.serving import ServingEngine as JEngine
from repro.serving.engine import BatchedEngine as JBatched
from repro.training.train import loss_fn as jloss_fn
from repro_torch.convert import params_from_numpy
from repro_torch.core.controller import CascadeController
from repro_torch.models import attention as tattn
from repro_torch.models import rope as trope
from repro_torch.models import transformer as tT
from repro_torch.serving import BatchedEngine, NGramDrafter, ServingEngine
from repro_torch.training import loss_fn
from test_torch_batching import _hw_pair, _share_jits
from test_torch_guards import torch_one_thread  # noqa: F401,E402 (autouse)

ARCHS = ["chatglm3-6b", "qwen2-vl-7b", "whisper-large-v3"]
OP_ATOL = 1e-6
LOGIT_ATOL = 1e-5
MAX_NEW = 16

_MODELS: dict = {}


def _model(arch):
    """(reduced cfg, JAX params, their torch copy), built once an arch."""
    if arch not in _MODELS:
        cfg = jax_get_config(arch).reduced()
        jp = jT.init_params(cfg, jax.random.PRNGKey(ARCHS.index(arch)))
        _MODELS[arch] = (cfg, jp, params_from_numpy(jax.device_get(jp),
                                                    device="cpu"))
    return _MODELS[arch]


def _np(x):
    return x.detach().numpy()


def _close(got, ref, rel=OP_ATOL):
    """max|got - ref| <= rel * max|ref|."""
    got, ref = np.asarray(got), np.asarray(ref)
    err = float(np.abs(got - ref).max())
    assert err <= rel * float(np.abs(ref).max()), err


def _enc(cfg, b=1, seed=0):
    """Encoder states [b, encoder_len, encoder_d_model], seeded."""
    rng = np.random.default_rng(seed)
    return rng.normal(size=(b, cfg.encoder_len, cfg.encoder_d_model)
                      ).astype(np.float32)


# --------------------------------------------------------------------- #
# Ops
# --------------------------------------------------------------------- #

def test_rope_2d_and_mrope_equal_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 3, 64)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        _np(trope.apply_rope_2d(torch.from_numpy(x), torch.from_numpy(pos))),
        np.asarray(jrope.apply_rope_2d(jnp.asarray(x), jnp.asarray(pos))),
        rtol=0, atol=OP_ATOL)
    pos3 = rng.integers(0, 300, (3, 2, 5)).astype(np.int32)
    sections = (8, 12, 12)
    np.testing.assert_allclose(
        _np(trope.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3),
                              sections)),
        np.asarray(jrope.apply_mrope(jnp.asarray(x), jnp.asarray(pos3),
                                     sections)), rtol=0, atol=OP_ATOL)
    # the text-only case: [B,S] positions drive t, h and w alike
    cfg = jax_get_config("qwen2-vl-7b").reduced()
    assert sum(cfg.mrope_sections) == cfg.head_dim // 2
    xq = rng.normal(size=(2, 5, 3, cfg.head_dim)).astype(np.float32)
    got = trope.apply_positional(cfg, torch.from_numpy(xq),
                                 torch.from_numpy(pos))
    np.testing.assert_allclose(
        _np(got), np.asarray(jrope.apply_positional(cfg, jnp.asarray(xq),
                                                    jnp.asarray(pos))),
        rtol=0, atol=OP_ATOL)
    np.testing.assert_array_equal(
        _np(got), _np(trope.apply_mrope(
            torch.from_numpy(xq),
            torch.from_numpy(np.broadcast_to(pos, (3, 2, 5)).copy()),
            cfg.mrope_sections)))
    with pytest.raises(ValueError, match="sections"):
        trope.apply_mrope(torch.from_numpy(xq), torch.from_numpy(pos3),
                          (1, 2, 3))


def test_sinusoid_and_cross_attention_equal_reference():
    """`_sinusoid` at atol 1e-6 over the positions of the passes below
    (0-15). XLA's float32 `exp` and torch's differ in the last bit for a
    few frequencies, so the angle at position p may differ by p ulps of a
    frequency <= 1: at p = 300 the test allows p * 2**-23."""
    cfg, jp, tp = _model("whisper-large-v3")
    for pos, atol in ((np.arange(16, dtype=np.int32)[None], OP_ATOL),
                      (np.array([[300]], np.int32), 300 * 2.0 ** -23)):
        np.testing.assert_allclose(
            _np(tT._sinusoid(torch.from_numpy(pos), cfg.d_model)),
            np.asarray(jT._sinusoid(jnp.asarray(pos), cfg.d_model)),
            rtol=0, atol=atol)
    jx = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["xattn"])
    tx = {k: v[0] for k, v in tp["blocks"]["xattn"].items()}
    enc = _enc(cfg, 2)
    jk, jv = jattn.encode_cross_kv(cfg, jx, jnp.asarray(enc))
    tk, tv = tattn.encode_cross_kv(cfg, tx, torch.from_numpy(enc))
    assert tk.shape == (2, cfg.encoder_len, cfg.num_heads, cfg.head_dim)
    _close(_np(tk), jk)
    _close(_np(tv), jv)
    x = np.random.default_rng(2).normal(size=(2, 3, cfg.d_model)).astype(
        np.float32)
    # the same K/V on both sides, so only the attention differs
    _close(_np(tattn.cross_attention(cfg, tx, torch.from_numpy(x),
                                     torch.from_numpy(np.array(jk)),
                                     torch.from_numpy(np.array(jv)))),
           jattn.cross_attention(cfg, jx, jnp.asarray(x), jk, jv))


# --------------------------------------------------------------------- #
# Passes
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference_and_full_forward_and_rollback(arch):
    cfg, jp, tp = _model(arch)
    enc = _enc(cfg) if cfg.is_encoder_decoder else None
    jenc = None if enc is None else jnp.asarray(enc)
    tenc = None if enc is None else torch.from_numpy(enc)
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, 15)).astype(np.int32)
    jt, tt = jnp.asarray(toks), torch.from_numpy(toks)

    jfull, _ = jT.train_forward(cfg, jp, jt, moe_exact=True, enc_out=jenc)
    full, _ = tT.train_forward(cfg, tp, tt, enc_out=tenc)
    np.testing.assert_allclose(_np(full), np.asarray(jfull), rtol=0,
                               atol=LOGIT_ATOL)
    jc = jT.init_cache(cfg, 1, 64)
    tc = tT.init_cache(cfg, 1, 64, device="cpu")
    assert sorted(tc) == sorted(jc)
    _, jc, _ = jT.prefill(cfg, jp, jt[:, :12], jc, enc_out=jenc)
    _, tc, _ = tT.prefill(cfg, tp, tt[:, :12], tc, enc_out=tenc)
    jlo, jc2, _, jst = jT.decode_step(cfg, jp, jc, jt[:, 12:15])
    lo, tc2, _, st = tT.decode_step(cfg, tp, tc, tt[:, 12:15])
    np.testing.assert_allclose(_np(lo), np.asarray(jlo), rtol=0,
                               atol=LOGIT_ATOL)
    np.testing.assert_allclose(_np(lo), _np(full[:, 12:15]), rtol=0,
                               atol=LOGIT_ATOL)
    assert ("enc_k" in tc2) == cfg.is_encoder_decoder
    if cfg.is_encoder_decoder:
        for layer in range(cfg.num_layers):
            xp = {k: v[layer] for k, v in tp["blocks"]["xattn"].items()}
            for name, want in zip(("enc_k", "enc_v"),
                                  tattn.encode_cross_kv(cfg, xp, tenc)):
                np.testing.assert_array_equal(_np(tc2[name][layer]),
                                              _np(want))
                _close(_np(tc2[name][layer]), jc2[name][layer])
    # reject 2 of 3, roll back, verify again
    jc3 = jT.rollback_cache(cfg, jc2, jst, 1, 12)
    tc3 = tT.rollback_cache(cfg, tc2, st, 1, 12)
    assert int(tc3["length"]) == int(jc3["length"]) == 13
    np.testing.assert_array_equal(_np(tc3["pos"]), np.asarray(jc3["pos"]))
    jlo2, jc4, _, _ = jT.decode_step(cfg, jp, jc3, jt[:, 13:15])
    lo2, tc4, _, _ = tT.decode_step(cfg, tp, tc3, tt[:, 13:15])
    np.testing.assert_allclose(_np(lo2), np.asarray(jlo2), rtol=0,
                               atol=LOGIT_ATOL)
    np.testing.assert_allclose(_np(lo2), _np(full[:, 13:15]), rtol=0,
                               atol=LOGIT_ATOL)
    np.testing.assert_array_equal(_np(tc4["pos"]), np.asarray(jc4["pos"]))
    assert int(tc4["length"]) == int(jc4["length"]) == 15
    if cfg.is_encoder_decoder:
        for name in ("enc_k", "enc_v"):   # rollback never touches them
            np.testing.assert_array_equal(_np(tc4[name]), _np(tc2[name]))
            _close(_np(tc4[name]), jc4[name])


def _grid_inputs(cfg, b=1, side=4, n_text=6, seed=4):
    """`side` x `side` patch embeddings (t fixed, h the row, w the column)
    followed by `n_text` embedded text tokens whose ids continue from the
    grid's largest id plus 1: (embeds [b,T,d], rope_pos [3,b,T], tokens
    [b,n_text]) as numpy."""
    rng = np.random.default_rng(seed)
    n_img = side * side
    patches = rng.normal(size=(b, n_img, cfg.d_model)).astype(np.float32)
    rows, cols = np.divmod(np.arange(n_img), side)
    img = np.stack([np.zeros(n_img), rows, cols]).astype(np.int32)
    start = img.max() + 1
    txt = np.broadcast_to(np.arange(start, start + n_text, dtype=np.int32),
                          (3, n_text))
    pos = np.broadcast_to(np.concatenate([img, txt], 1)[:, None],
                          (3, b, n_img + n_text)).copy()
    tokens = rng.integers(0, cfg.vocab_size, (b, n_text)).astype(np.int32)
    return patches, pos, tokens


def test_qwen2_vl_prefill_by_embeds_and_rope_pos_matches_reference():
    cfg, jp, tp = _model("qwen2-vl-7b")
    patches, pos, tokens = _grid_inputs(cfg)
    jemb = jnp.concatenate([jnp.asarray(patches), jT.L.embed_tokens(
        jp["embed"], jnp.asarray(tokens))], 1)
    temb = torch.cat([torch.from_numpy(patches), tT.L.embed_tokens(
        tp["embed"], torch.from_numpy(tokens))], 1)
    np.testing.assert_array_equal(_np(temb), np.asarray(jemb))
    jc = jT.init_cache(cfg, 1, 64)
    tc = tT.init_cache(cfg, 1, 64, device="cpu")
    jlo, jc, _ = jT.prefill(cfg, jp, None, jc, embeds=jemb,
                            rope_pos=jnp.asarray(pos))
    lo, tc, _ = tT.prefill(cfg, tp, None, tc, embeds=temb,
                           rope_pos=torch.from_numpy(pos))
    np.testing.assert_allclose(_np(lo), np.asarray(jlo), rtol=0,
                               atol=LOGIT_ATOL)
    np.testing.assert_allclose(_np(tc["k"]), np.asarray(jc["k"]), rtol=0,
                               atol=OP_ATOL * 10)
    assert int(tc["length"]) == int(jc["length"]) == pos.shape[-1]
    # the next span rotates by its sequence positions, the reference's
    # default after a multimodal prefill
    span = np.array([[5, 9, 2]], np.int32)
    jlo, jc2, _, _ = jT.decode_step(cfg, jp, jc, jnp.asarray(span))
    lo, tc2, _, _ = tT.decode_step(cfg, tp, tc, torch.from_numpy(span))
    np.testing.assert_allclose(_np(lo), np.asarray(jlo), rtol=0,
                               atol=LOGIT_ATOL)
    np.testing.assert_array_equal(_np(tc2["pos"]), np.asarray(jc2["pos"]))


def assert_loss_and_grads(cfg, jp, tp, jb, tb, rel=1e-5, floor=1e-7):
    """The port's `loss_fn` and the gradient of every parameter on `tb`
    against `jax.value_and_grad` of the reference's on `jb`, over the same
    params (`tp` converted from `jp`): the loss within `rel` of |loss|,
    each leaf's gradient within rel * max|g_ref| + floor (a leaf the pass
    does not read must have a zero reference gradient). Returns the
    number of leaves compared."""
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jloss_fn(cfg, p, jb), has_aux=True))(jp)
    flat = jax.tree_util.tree_flatten_with_path(jg)[0]
    live = {}

    def rebuild(tree, path=()):
        if isinstance(tree, dict):
            return {k: rebuild(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(rebuild(v, path + (i,))
                              for i, v in enumerate(tree))
        live[path] = tree.detach().clone().requires_grad_()
        return live[path]

    keys = [tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
            for path, _ in flat]
    loss, _ = loss_fn(cfg, rebuild(tp), tb)
    grads = torch.autograd.grad(loss, [live[k] for k in keys],
                                allow_unused=True)
    assert abs(loss.item() - float(jl)) <= rel * abs(float(jl)), \
        (loss.item(), float(jl))
    for key, g, (_, jgl) in zip(keys, grads, flat):
        ref = np.asarray(jgl)
        if g is None:
            assert not ref.any(), key
            continue
        err = float(np.abs(_np(g) - ref).max())
        assert err <= rel * float(np.abs(ref).max()) + floor, (key, err)
    return len(keys)


def test_train_forward_by_embeds_and_rope_pos_logits_and_gradients():
    """Logits within atol 1e-5; each parameter's gradient within 1e-5 of
    the largest |gradient| of its leaf, + 1e-7 (the token embedding, which
    the pass does not read, gets none)."""
    cfg, jp, tp = _model("qwen2-vl-7b")
    patches, pos, tokens = _grid_inputs(cfg, b=2, side=3, n_text=5)
    emb = np.concatenate([patches, np.asarray(jT.L.embed_tokens(
        jp["embed"], jnp.asarray(tokens)))], 1)
    labels = np.random.default_rng(5).integers(
        0, cfg.vocab_size, emb.shape[:2]).astype(np.int32)
    jb = {"embeds": jnp.asarray(emb), "rope_pos": jnp.asarray(pos),
          "labels": jnp.asarray(labels)}
    tb = {"embeds": torch.from_numpy(emb), "rope_pos": torch.from_numpy(pos),
          "labels": torch.from_numpy(labels)}
    jlog, _ = jT.train_forward(cfg, jp, None, embeds=jb["embeds"],
                               rope_pos=jb["rope_pos"])
    tlog, _ = tT.train_forward(cfg, tp, None, embeds=tb["embeds"],
                               rope_pos=tb["rope_pos"])
    np.testing.assert_allclose(_np(tlog), np.asarray(jlog), rtol=0,
                               atol=LOGIT_ATOL)
    assert assert_loss_and_grads(cfg, jp, tp, jb, tb) > 10


def test_trainer_refuses_an_encoder_output():
    """Whisper trains with its encoder output (the refusal this test held
    is lifted): `loss_fn` with `enc_out` and every parameter's gradient,
    cross-attention's included, against `jax.value_and_grad` of the
    reference's, within 1e-5 * max|g_ref| + 1e-7 a leaf and 1e-5 of the
    loss; without `enc_out` the training pass raises ValueError, as the
    prefill does."""
    cfg, jp, tp = _model("whisper-large-v3")
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    enc = _enc(cfg, 2, seed=3)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
          "enc_out": jnp.asarray(enc)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels),
          "enc_out": torch.from_numpy(enc)}
    assert assert_loss_and_grads(cfg, jp, tp, jb, tb) > 10
    with pytest.raises(ValueError, match="enc_out"):
        loss_fn(cfg, tp, {"tokens": tb["tokens"], "labels": tb["labels"]})


# --------------------------------------------------------------------- #
# Engines
# --------------------------------------------------------------------- #

def _prompts(cfg, n=3):
    """Periodic prompts over 8 tokens, so the n-gram drafter proposes; one
    length, so the JAX engines compile one prefill."""
    rng = np.random.default_rng(0)
    return [[1] + rng.integers(3, cfg.vocab_size, 8).tolist() * 3
            for _ in range(n)]


def _serve(eng, prompts, encs):
    pending, live, done = list(enumerate(prompts)), {}, {}
    while pending or live:
        while pending and eng.free_slots:
            i, p = pending.pop(0)
            live[eng.join(p, MAX_NEW, request_id=str(i),
                          enc_out=encs[i])] = i
        eng.step()
        for slot, i in list(live.items()):
            if eng.slots[slot].done:
                done[i] = eng.retire(slot)
                del live[slot]
    return [done[i] for i in range(len(prompts))]


@pytest.mark.parametrize("engine", ["serving", "batched"])
@pytest.mark.parametrize("arch", ["whisper-large-v3", "chatglm3-6b"])
def test_engines_equal_jax(arch, engine):
    cfg, jp, tp = _model(arch)
    jhw, thw = _hw_pair()
    kw = dict(max_len=128, temperature=0.0, clock="model")
    prompts = _prompts(cfg)
    encs = ([_enc(cfg, seed=10 + i) for i in range(len(prompts))]
            if cfg.is_encoder_decoder else [None] * len(prompts))
    jencs = [None if e is None else jnp.asarray(e) for e in encs]
    tencs = [None if e is None else torch.from_numpy(e) for e in encs]
    if engine == "serving":
        jeng = _share_jits(JEngine(cfg, jp, JNGram(),
                                   controller_factory=JCascade, hw=jhw, **kw))
        teng = ServingEngine(cfg, tp, NGramDrafter(),
                             controller_factory=CascadeController, hw=thw,
                             device="cpu", **kw)
        jres = [jeng.generate(p, max_new=MAX_NEW, request_id=str(i),
                              enc_out=jencs[i])
                for i, p in enumerate(prompts)]
        tres = [teng.generate(p, max_new=MAX_NEW, request_id=str(i),
                              enc_out=tencs[i])
                for i, p in enumerate(prompts)]
    else:
        bkw = dict(max_batch=2, chunk=8, **kw)
        jeng = _share_jits(JBatched(cfg, jp, controller_factory=JCascade,
                                    hw=jhw, **bkw))
        teng = BatchedEngine(cfg, tp, controller_factory=CascadeController,
                             hw=thw, device="cpu", **bkw)
        jres, tres = _serve(jeng, prompts, jencs), _serve(teng, prompts,
                                                          tencs)
        assert ([dataclasses.asdict(s) for s in teng.telemetry.steps]
                == [dataclasses.asdict(s) for s in jeng.telemetry.steps])
        assert teng.now == jeng.now
        # Whisper's requests take the blocking prefill, ChatGLM's chunks
        chunks = [r.telemetry.prefill_chunks for r in tres]
        assert (max(chunks) == 0) == cfg.is_encoder_decoder
    for t, j in zip(tres, jres):
        assert t.tokens == j.tokens
        assert dataclasses.asdict(t.telemetry) == dataclasses.asdict(
            j.telemetry)
    assert sum(it.k_drafted for r in tres
               for it in r.telemetry.iterations) > 0
    if cfg.is_encoder_decoder:   # the encoder output reaches the stream
        alone = ServingEngine(cfg, tp, NGramDrafter(), device="cpu", **kw)
        other = alone.generate(prompts[0], max_new=MAX_NEW,
                               enc_out=tencs[1]).tokens
        assert other != tres[0].tokens
