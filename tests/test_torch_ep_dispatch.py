"""The port's expert-parallel dispatch (`repro_torch.distributed`) over
torch.distributed on the CPU against the JAX package.

`_local_pack` (the send buffer and its slot bookkeeping) is held to the
reference's exactly, in this process. `make_expert_parallel_moe` runs on
four gloo ranks, spawned once for the module with a `file://` store: the
same ranks serve a (4, 1) and a (2, 2) data x model layout, each over a
reduced Mixtral layer and a reduced DeepSeek-MoE layer (shared experts,
whose F the model ranks split). Inputs and weights are float32 from a
numpy seed. Held, as the reference's own EP test holds its dispatch:
outputs against `apply_moe(capacity_policy="exact")` at atol 3e-5, rtol
1e-5 (float32 sums in another order), the gathered routing exactly,
`dropped` 0 where no quota can overflow and equal to the overflow
counted from the routing at `capacity_factor=1e-6`, the per-source
distinct counts exactly, `lb_loss` (the mean of the data ranks' local
losses) at rtol 0.05, and `apply_moe(ep=)`'s union and
`unique_experts_src`.

Gradients through the dispatch are held to the reference's
`jax.value_and_grad` under the same layouts: one JAX subprocess with four
forced host devices computes them (`make_expert_parallel_moe` on a
("data", "model") mesh, and the whole model under the "ep-a2a" option),
beside the ranks, on the same inputs. Per layer (reduced Mixtral and
DeepSeek-MoE) the gradients of sum(y * g) + lb_loss with respect to
every weight and the tokens; for the reduced OLMoE (2 layers, 4 experts
top-2) on a [4, 16] batch the loss, its parts, every parameter's
gradient and each layer's routing and drops, its
`prefill(moe_exact=False)` (logits, cache, routing), and at (4, 1) the
parameters after one step of the config's own optimizer (AdamW). Each
rank differentiates its share of the loss; the gradients of leaves every
data rank holds are summed (`reduce_gradients`) and the slices gathered
(`gather_params`). Gradients are held at GRAD_REL * max|g_ref| +
GRAD_FLOOR per leaf (float32 sums taken over other ranks' partial sums,
in another order than XLA's; the worst leaf, the reduced OLMoE's router,
measured at 0.36 of the limit), the loss at 1e-6 relative, routing and
drops exactly, the stepped parameters within what those gradient errors
can move an AdamW step (see `test_model_train_step_matches_jax`)."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.distributed.expert_parallel import _local_pack as j_local_pack
from repro.models import moe as jmoe
from repro.models import transformer as jT
from repro_torch.configs import get_config
from repro_torch.distributed.expert_parallel import _local_pack
from test_torch_guards import torch_one_thread  # noqa: F401,E402 (autouse)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("mixtral-8x7b", "deepseek-moe-16b")   # the same names in both
MODEL = "olmoe-1b-7b"                          # trained whole, reduced
T_TOKENS = 32
BATCH = (4, 16)                                # the whole model's [B, S]
LAYOUTS = ((4, 1), (2, 2))
ATOL, RTOL = 3e-5, 1e-5
GRAD_REL, GRAD_FLOOR = 1e-5, 1e-7
ADAFACTOR_TOL = 1e-3

_RANKS = textwrap.dedent(r'''
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from repro_torch.configs import get_config
    from repro_torch.distributed import (gather_params,
                                         make_expert_parallel_moe,
                                         reduce_gradients, shard_moe_params,
                                         shard_params)
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    from repro_torch.training import (make_optimizer, make_train_step,
                                      value_and_grad, warmup_cosine)
    from repro_torch.training.optimizer import tree_leaves, tree_map

    def _flat(prefix, tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(_flat(f"{prefix}{k}/", v))
            else:
                out[prefix + k] = v
        return out

    def _tensors(z, prefix):
        out = {}
        for key in z.files:
            if key.startswith(prefix):
                *path, name = key[len(prefix):].split("/")
                node = out
                for part in path:
                    node = node.setdefault(part, {})
                node[name] = torch.from_numpy(z[key])
        return out

    def _layer_grads(cfg, p_loc, x_loc, g_loc, ep, nd):
        """d/d(p, x) of this rank's share of sum(y * g) + lb_loss."""
        live = tree_map(lambda t: t.clone().requires_grad_(), p_loc)
        x_l = x_loc.clone().requires_grad_()
        y, aux = ep(live, x_l)
        share = (y * g_loc).sum() + aux["lb_loss_local"] / nd
        flat = torch.autograd.grad(share, [x_l] + tree_leaves(live))
        it = iter(flat[1:])
        gp = {"moe": tree_map(lambda _: next(it), live)}
        gp = gather_params(reduce_gradients(gp, ep), ep)["moe"]
        return flat[0], gp

    def _routed(fn, tag, res):
        """fn(), with each MoE layer's routing and drops kept in res."""
        routes, apply_moe = [], moe.apply_moe

        def recording(*a, **kw):
            y, aux = apply_moe(*a, **kw)
            routes.append((aux["expert_idx"], aux["dropped"]))
            return y, aux
        moe.apply_moe = recording
        try:
            out = fn()
        finally:
            moe.apply_moe = apply_moe
        for i, (idx, dropped) in enumerate(routes):
            res[f"{tag}route{i}/expert_idx"] = idx
            res[f"{tag}route{i}/dropped"] = dropped
        return out

    def _prefill_run(cfg, params, tokens, ep, tag, res):
        """`prefill(moe_exact=False, ep=)` of this rank's rows into a cache
        of as many rows: logits, cache, aux and each layer's routing."""
        b_loc = len(tokens) // ep.n_data
        rows = tokens[ep.data_rank * b_loc:(ep.data_rank + 1) * b_loc]
        cache = T.init_cache(cfg, b_loc, rows.shape[1], device="cpu")
        with torch.no_grad():
            logits, cache, aux = _routed(lambda: T.prefill(
                cfg, shard_params(cfg, params, *ep.ranks), rows, cache,
                moe_exact=False, ep=ep), tag, res)
        res[tag + "logits"] = logits
        for k, v in cache.items():
            res[f"{tag}cache/{k}"] = v
        for k, v in aux.items():
            res[f"{tag}aux/{k}"] = v

    def _model_run(rank, cfg, params, batch, ep, tag, res):
        """Loss, gradients and per-layer routing of this rank's rows
        through the dispatch; rank 0 keeps the gathered gradients, every
        rank each leaf's sum of squares."""
        di, nd = ep.data_rank, ep.n_data
        rows = {k: v[di * (len(v) // nd):(di + 1) * (len(v) // nd)]
                for k, v in batch.items()}
        loss, parts, grads = _routed(lambda: value_and_grad(
            cfg, shard_params(cfg, params, *ep.ranks), rows, ep=ep), tag, res)
        full = _flat("", gather_params(grads, ep))
        res[tag + "loss"] = loss
        for k, v in parts.items():
            res[f"{tag}{k}"] = v
        for k, v in full.items():
            res[f"{tag}sq/{k}"] = v.double().square().sum()
            if rank == 0:
                res[f"{tag}grad/{k}"] = v
        # one step, on a copy: at (4, 1) of the config's own optimizer
        # (AdamW), at (2, 2) of Adafactor, whose statistics over a leaf
        # cut in F sum over the model group
        opt = make_optimizer(cfg.optimizer if nd == 4 else "adafactor",
                             warmup_cosine(3e-4, 100, 10_000))
        _, step = make_train_step(cfg, optimizer=opt, ep=ep)
        p_loc = tree_map(lambda t: t.clone(),
                         shard_params(cfg, params, *ep.ranks))
        (p_new, _), m = step((p_loc, opt.init(p_loc)), rows)
        for k, v in m.items():
            res[f"{tag}step/{k}"] = v
        # every rank takes part in the gather; rank 0 keeps it
        p_new = _flat("", gather_params(p_new, ep))
        if rank == 0:
            for k, v in p_new.items():
                res[f"{tag}step/p/{k}"] = v

    def run(rank, out_dir, archs, layouts):
        dist.init_process_group("gloo", init_method=f"file://{out_dir}/store",
                                rank=rank, world_size=4)
        groups = {}
        for nd, nm in layouts:
            data = [dist.new_group([m + nm * i for i in range(nd)])
                    for m in range(nm)]
            model = ([dist.new_group([nm * i + m for m in range(nm)])
                      for i in range(nd)] if nm > 1 else None)
            groups[(nd, nm)] = (data, model)
        z = np.load(f"{out_dir}/inputs.npz")
        res = {}
        for arch in archs:
            cfg = get_config(arch).reduced()
            p = _tensors(z, arch + "/p/")
            x = torch.from_numpy(z[arch + "/x"])
            for nd, nm in layouts:
                di, mi = rank // nm, rank % nm
                data, model = groups[(nd, nm)]
                dg, mg = data[mi], (None if model is None else model[di])
                t_loc = x.shape[0] // nd
                x_loc = x[di * t_loc:(di + 1) * t_loc]
                p_loc = shard_moe_params(cfg, p, di, nd, mi, nm)
                tag = f"{arch}/{nd}x{nm}/"
                with torch.no_grad():
                    for cf in (2.0, 1e-6):
                        ep = make_expert_parallel_moe(cfg, dg, mg,
                                                      capacity_factor=cf)
                        y, aux = ep(p_loc, x_loc)
                        res[f"{tag}{cf}/y"] = y
                        for k, v in aux.items():
                            res[f"{tag}{cf}/{k}"] = v
                    ep = make_expert_parallel_moe(cfg, dg, mg)
                    y, aux = moe.apply_moe(cfg, p_loc, x_loc,
                                           capacity_policy="serve", ep=ep)
                    res[tag + "wrap/y"] = y
                    for k in ("unique_experts", "unique_experts_src",
                              "dropped"):
                        res[f"{tag}wrap/{k}"] = aux[k]
                    # "exact" keeps the dense path (over the whole
                    # layer), as in the reference
                    y, aux = moe.apply_moe(cfg, p, x_loc,
                                           capacity_policy="exact", ep=ep)
                    res[tag + "exact-policy/has_src"] = torch.tensor(
                        "unique_experts_src" in aux)
                ep = make_expert_parallel_moe(cfg, dg, mg)
                g_loc = torch.from_numpy(z[arch + "/g"])[
                    di * t_loc:(di + 1) * t_loc]
                gx, gp = _layer_grads(cfg, p_loc, x_loc, g_loc, ep, nd)
                res[tag + "grad/x"] = gx
                if rank == 0:
                    for k, v in _flat(tag + "grad/p/", gp).items():
                        res[k] = v
        cfg = get_config("olmoe-1b-7b").reduced()
        params = _tensors(z, "model/p/")
        batch = {k: torch.from_numpy(z["model/" + k])
                 for k in ("tokens", "labels")}
        for nd, nm in layouts:
            di, mi = rank // nm, rank % nm
            data, model = groups[(nd, nm)]
            ep = make_expert_parallel_moe(
                cfg, data[mi], None if model is None else model[di])
            _model_run(rank, cfg, params, batch, ep, f"model/{nd}x{nm}/",
                       res)
            _prefill_run(cfg, params, batch["tokens"], ep,
                         f"model/{nd}x{nm}/prefill/", res)
        np.savez(f"{out_dir}/rank{rank}.npz",
                 **{k: v.detach().numpy() for k, v in res.items()})
        dist.barrier()
        dist.destroy_process_group()

    if __name__ == "__main__":
        out_dir = sys.argv[1]
        archs = sys.argv[2].split(",")
        layouts = [tuple(int(v) for v in s.split("x"))
                   for s in sys.argv[3].split(",")]
        mp.spawn(run, args=(out_dir, archs, layouts), nprocs=4, join=True)
''')


_JAX_EP = textwrap.dedent(r'''
    import sys
    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.configs import get_config
    from repro.distributed import sharding as sh
    from repro.distributed.expert_parallel import make_expert_parallel_moe
    from repro.models import attention as attn
    from repro.models import layers as L
    from repro.models import moe as moe_mod
    from repro.models import transformer as T
    from repro.training import train as tr

    assert jax.device_count() == 4, jax.devices()

    def tree(z, prefix):
        out = {}
        for key in z.files:
            if key.startswith(prefix):
                *path, name = key[len(prefix):].split("/")
                node = out
                for part in path:
                    node = node.setdefault(part, {})
                node[name] = jnp.asarray(z[key])
        return out

    def flat(prefix, t):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out.update(flat(f"{prefix}{k}/", v))
            else:
                out[prefix + k] = np.asarray(v)
        return out

    def routing(cfg, params, tokens):
        """Each layer's routing and drops under "ep-a2a", layer by layer:
        the attention half of `_attn_block`, then `apply_moe`."""
        b, t = tokens.shape
        pos = jnp.broadcast_to(jnp.arange(t, dtype=jnp.int32), (b, t))
        x = L.embed_tokens(params["embed"], tokens)
        out = []
        for layer in range(cfg.num_layers):
            p = jax.tree_util.tree_map(lambda a: a[layer], params["blocks"])
            h = L.apply_norm(cfg, p["ln1"], x)
            q, k, v = attn.qkv(cfg, p["attn"], h, pos)
            a = attn.attend(q, k, v, pos, pos, window=cfg.window,
                            causal=True)
            x = x + a.reshape(b, t, -1) @ p["attn"]["wo"]
            h2 = L.apply_norm(cfg, p["ln2"], x)
            y, aux = moe_mod.apply_moe(cfg, p["moe"], h2.reshape(b * t, -1),
                                       capacity_policy="train")
            assert "unique_experts_src" in aux      # the EP path ran
            x = x + y.reshape(b, t, -1)
            out.append((aux["expert_idx"], aux["dropped"]))
        return out

    out_dir, archs = sys.argv[1], sys.argv[2].split(",")
    layouts = [tuple(int(v) for v in s.split("x"))
               for s in sys.argv[3].split(",")]
    z = np.load(f"{out_dir}/inputs.npz")
    res = {}
    mcfg = get_config("olmoe-1b-7b").reduced()
    params = tree(z, "model/p/")
    batch = {k: jnp.asarray(z["model/" + k]) for k in ("tokens", "labels")}
    for nd, nm in layouts:
        mesh = Mesh(np.array(jax.devices()).reshape(nd, nm),
                    ("data", "model"))
        for arch in archs:
            cfg = get_config(arch).reduced()
            apply = make_expert_parallel_moe(cfg, mesh)
            g = jnp.asarray(z[arch + "/g"])

            def share(p, x):
                y, aux = apply(p, x)
                return jnp.sum(y * g) + aux["lb_loss"]
            _, (gp, gx) = jax.jit(jax.value_and_grad(share, argnums=(0, 1)))(
                tree(z, arch + "/p/"), jnp.asarray(z[arch + "/x"]))
            tag = f"{arch}/{nd}x{nm}/"
            res[tag + "grad/x"] = np.asarray(gx)
            res.update(flat(tag + "grad/p/", gp))
        sh.set_options(["ep-a2a"], mesh)
        try:
            tag = f"model/{nd}x{nm}/"
            (loss, parts), grads = jax.jit(jax.value_and_grad(
                lambda p: tr.loss_fn(mcfg, p, batch), has_aux=True))(params)
            res[tag + "loss"] = np.asarray(loss)
            for k, v in parts.items():
                res[tag + k] = np.asarray(v)
            res.update(flat(tag + "grad/", grads))
            for i, (idx, dropped) in enumerate(jax.jit(
                    routing, static_argnums=0)(mcfg, params,
                                               batch["tokens"])):
                res[f"{tag}route{i}/expert_idx"] = np.asarray(idx)
                res[f"{tag}route{i}/dropped"] = np.asarray(dropped)
            logits, cache, aux = jax.jit(
                lambda p, t, c: T.prefill(mcfg, p, t, c, moe_exact=False))(
                    params, batch["tokens"],
                    T.init_cache(mcfg, *batch["tokens"].shape))
            res[tag + "prefill/logits"] = np.asarray(logits)
            res.update(flat(tag + "prefill/cache/", cache))
            res.update(flat(tag + "prefill/aux/", aux))
            opt = tr.make_optimizer(
                mcfg.optimizer if nd == 4 else "adafactor",
                tr.warmup_cosine(3e-4, 100, 10_000))
            _, step = tr.make_train_step(mcfg, optimizer=opt)
            (p_new, _), m = jax.jit(step)((params, opt.init(params)), batch)
            for k, v in m.items():
                res[f"{tag}step/{k}"] = np.asarray(v)
            res.update(flat(tag + "step/p/", p_new))
        finally:
            sh.set_options([], None)
    np.savez(f"{out_dir}/jax_ep.npz", **res)
''')


def _layer(arch, seed):
    """One MoE layer's float32 params and T_TOKENS inputs, from a numpy
    seed: the router at 0.02, expert weights at 1/sqrt(fan-in)."""
    cfg = get_config(arch).reduced()
    rng = np.random.default_rng(seed)
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff

    def w(*shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    p = {"router": w(d, e, scale=0.02), "w_gate": w(e, d, f, scale=d ** -.5),
         "w_up": w(e, d, f, scale=d ** -.5),
         "w_down": w(e, f, d, scale=f ** -.5)}
    if cfg.num_shared_experts:
        fs = f * cfg.num_shared_experts
        p["shared"] = {"w_gate": w(d, fs, scale=d ** -.5),
                       "w_up": w(d, fs, scale=d ** -.5),
                       "w_down": w(fs, d, scale=fs ** -.5)}
    return p, w(T_TOKENS, d, scale=1.0)


def _jax(tree):
    return {k: _jax(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


def _flat(prefix, tree):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(f"{prefix}{k}/", v))
        else:
            out[prefix + k] = v
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The JAX references and the four ranks' results, by arch; the JAX
    subprocess's gradients under the EP layouts (run beside the ranks)."""
    out_dir = tmp_path_factory.mktemp("ep_ranks")
    inputs, refs = {}, {}
    for i, arch in enumerate(ARCHS):
        p, x = _layer(arch, seed=40 + i)
        inputs.update(_flat(f"{arch}/p/", p))
        inputs[f"{arch}/x"] = x
        inputs[f"{arch}/g"] = np.random.default_rng(50 + i).standard_normal(
            x.shape).astype(np.float32)
        jcfg = jax_get_config(arch).reduced()
        y, aux = jmoe.apply_moe(jcfg, _jax(p), jnp.asarray(x),
                                capacity_policy="exact")
        refs[arch] = (np.asarray(y), {k: np.asarray(v)
                                      for k, v in aux.items()})
    jp = jT.init_params(jax_get_config(MODEL).reduced(), jax.random.PRNGKey(3))
    inputs.update(_flat("model/p/", jax.device_get(jp)))
    rng = np.random.default_rng(60)
    for k in ("tokens", "labels"):
        inputs["model/" + k] = rng.integers(
            0, jax_get_config(MODEL).reduced().vocab_size,
            BATCH).astype(np.int32)
    np.savez(out_dir / "inputs.npz", **inputs)
    args = [str(out_dir), ",".join(ARCHS),
            ",".join(f"{nd}x{nm}" for nd, nm in LAYOUTS)]
    procs = {}
    for name, text, extra in (
            ("ranks", _RANKS, {"OMP_NUM_THREADS": "1"}),
            ("jax_ep", _JAX_EP, {"JAX_PLATFORMS": "cpu", "XLA_FLAGS": (
                os.environ.get("XLA_FLAGS", "")
                + " --xla_force_host_platform_device_count=4").strip()})):
        script = out_dir / f"{name}.py"
        script.write_text(text)
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **extra)
        with open(out_dir / f"{name}.log", "w") as log:
            procs[name] = subprocess.Popen(
                [sys.executable, str(script)] + args, env=env,
                stdout=log, stderr=subprocess.STDOUT)
    for name, proc in procs.items():
        proc.wait(timeout=300)
        assert proc.returncode == 0, (out_dir / f"{name}.log").read_text()
    got = [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(4)]
    return refs, got, dict(np.load(out_dir / "jax_ep.npz"))


def _tokens_of(rank, layout):
    """The token rows [lo, hi) the rank's data index holds."""
    nd, nm = layout
    t_loc = T_TOKENS // nd
    di = rank // nm
    return di * t_loc, (di + 1) * t_loc


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: f"{l[0]}x{l[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_matches_exact_apply_moe(ranks, arch, layout):
    refs, got, _ = ranks
    y_ref, aux_ref = refs[arch]
    assert int(aux_ref["dropped"]) == 0
    tag = f"{arch}/{layout[0]}x{layout[1]}/2.0/"
    idx = aux_ref["expert_idx"]
    nd = layout[0]
    src_counts = [len(np.unique(idx[s * (T_TOKENS // nd):
                                    (s + 1) * (T_TOKENS // nd)]))
                  for s in range(nd)]
    for r in range(4):
        lo, hi = _tokens_of(r, layout)
        np.testing.assert_allclose(got[r][tag + "y"], y_ref[lo:hi],
                                   atol=ATOL, rtol=RTOL)
        np.testing.assert_array_equal(got[r][tag + "expert_idx"], idx)
        np.testing.assert_array_equal(got[r][tag + "dropped"], 0)
        np.testing.assert_array_equal(got[r][tag + "unique_experts"],
                                      src_counts)
        np.testing.assert_allclose(got[r][tag + "lb_loss"],
                                   aux_ref["lb_loss"], rtol=0.05)


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: f"{l[0]}x{l[1]}")
def test_dispatch_counts_dropped_exactly(ranks, layout):
    """At capacity_factor=1e-6 each (source rank, expert) bucket keeps one
    (token, choice): `dropped` per source equals the overflow counted on
    the host from the routing, and the outputs stay finite."""
    refs, got, _ = ranks
    nd = layout[0]
    t_loc = T_TOKENS // nd
    for arch in ARCHS:
        idx = refs[arch][1]["expert_idx"]
        expected = []
        for s in range(nd):
            _, counts = np.unique(idx[s * t_loc:(s + 1) * t_loc],
                                  return_counts=True)
            expected.append(int(np.maximum(counts - 1, 0).sum()))
        assert sum(expected) > 0
        tag = f"{arch}/{nd}x{layout[1]}/1e-06/"
        for r in range(4):
            np.testing.assert_array_equal(got[r][tag + "dropped"], expected)
            assert np.isfinite(got[r][tag + "y"]).all()


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: f"{l[0]}x{l[1]}")
def test_apply_moe_ep_union_and_sources(ranks, layout):
    """`apply_moe(ep=)`: the union is the dense path's distinct count (not
    the sum of the per-source counts, which double-counts experts several
    token shards share), the per-source counts stay under
    `unique_experts_src`, `dropped` is their sum, and the output is the
    dispatch's. Under capacity_policy="exact" the dense path runs."""
    refs, got, _ = ranks
    for arch in ARCHS:
        aux_ref = refs[arch][1]
        tag = f"{arch}/{layout[0]}x{layout[1]}/"
        for r in range(4):
            g = got[r]
            assert int(g[tag + "wrap/unique_experts"]) == \
                int(aux_ref["unique_experts"])
            np.testing.assert_array_equal(g[tag + "wrap/unique_experts_src"],
                                          g[tag + "2.0/unique_experts"])
            assert int(g[tag + "wrap/dropped"]) == 0
            np.testing.assert_allclose(g[tag + "wrap/y"], g[tag + "2.0/y"],
                                       atol=ATOL, rtol=RTOL)
            assert not bool(g[tag + "exact-policy/has_src"])


def _grad_close(got, ref, name):
    """max|got - ref| <= GRAD_REL * max|ref| + GRAD_FLOOR."""
    err = float(np.abs(got - ref).max())
    assert err <= GRAD_REL * float(np.abs(ref).max()) + GRAD_FLOOR, \
        (name, err, float(np.abs(ref).max()))


def test_dispatch_refuses_gradients(ranks):
    """The dispatch carries gradients (it refused them before): on every
    layout and rank the gradient of sum(y * g) + lb_loss with respect to
    the rank's tokens, and the gathered gradient of every weight (routed
    experts, shared experts, the router), equal the reference's
    `jax.value_and_grad` through its shard_map, with no factor of the
    model axis at (2, 2)."""
    _, got, jref = ranks
    for arch in ARCHS:
        for nd, nm in LAYOUTS:
            tag = f"{arch}/{nd}x{nm}/grad/"
            for r in range(4):
                lo, hi = _tokens_of(r, (nd, nm))
                _grad_close(got[r][tag + "x"], jref[tag + "x"][lo:hi],
                            tag + "x")
            keys = [k for k in jref if k.startswith(tag + "p/")]
            assert len(keys) == (7 if arch == "deepseek-moe-16b" else 4)
            for k in keys:
                _grad_close(got[0][k], jref[k], k)


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: f"{l[0]}x{l[1]}")
def test_model_loss_gradients_and_routing_match_jax(ranks, layout):
    """The reduced OLMoE's `loss_fn` through the dispatch, each rank on its
    rows of a [4, 16] batch: the loss and its parts on every rank, each
    layer's routing and drops exactly, every parameter's gathered
    gradient, and on every rank each leaf's sum of squares, against the
    reference under "ep-a2a" on the same layout."""
    _, got, jref = ranks
    tag = f"model/{layout[0]}x{layout[1]}/"
    for r in range(4):
        for k in ("loss", "ce", "lb"):
            np.testing.assert_allclose(got[r][tag + k], jref[tag + k],
                                       rtol=1e-6, err_msg=k)
        for i in range(jax_get_config(MODEL).reduced().num_layers):
            for k in ("expert_idx", "dropped"):
                key = f"{tag}route{i}/{k}"
                np.testing.assert_array_equal(got[r][key], jref[key])
    keys = [k[len(tag + "grad/"):] for k in jref if k.startswith(tag + "grad/")]
    assert len(keys) == len([k for k in got[0]
                             if k.startswith(tag + "grad/")]) > 10
    for k in keys:
        ref = jref[tag + "grad/" + k]
        _grad_close(got[0][tag + "grad/" + k], ref, k)
        for r in range(4):
            np.testing.assert_allclose(got[r][tag + "sq/" + k],
                                       np.square(ref.astype(np.float64)).sum(),
                                       rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: f"{l[0]}x{l[1]}")
def test_prefill_through_dispatch_matches_jax(ranks, layout):
    """`prefill(moe_exact=False, ep=)` of the reduced OLMoE, each rank its
    rows of the [4, 16] batch into a cache of as many rows, against the
    reference's `prefill(moe_exact=False)` of the whole batch under
    "ep-a2a" on the same layout: logits and the cache's K/V at ATOL, RTOL
    (float32 sums in another order), its positions and length exactly,
    the aux's per-layer expert union exactly and `lb_loss` at 1e-6
    relative, and each layer's routing and drops exactly against the
    reference's routing of the same batch (its prefill is the same
    forward from position 0, and returns no routing)."""
    _, got, jref = ranks
    nd, nm = layout
    tag = f"model/{nd}x{nm}/"
    b_loc = BATCH[0] // nd
    cache_keys = {k[len(tag + "prefill/cache/"):] for k in jref
                  if k.startswith(tag + "prefill/cache/")}
    assert {"k", "v", "pos", "length"} <= cache_keys
    for r in range(4):
        g = got[r]
        lo, hi = (r // nm) * b_loc, (r // nm + 1) * b_loc
        np.testing.assert_allclose(g[tag + "prefill/logits"],
                                   jref[tag + "prefill/logits"][lo:hi],
                                   atol=ATOL, rtol=RTOL)
        for k in cache_keys:
            ref = jref[tag + "prefill/cache/" + k]
            if k == "pos":
                ref = ref[lo:hi]
            elif k != "length":         # k, v: [L, B, ...]
                ref = ref[:, lo:hi]
            mine = g[tag + "prefill/cache/" + k]
            if np.issubdtype(ref.dtype, np.integer):
                np.testing.assert_array_equal(mine, ref, err_msg=k)
            else:
                np.testing.assert_allclose(mine, ref, atol=ATOL, rtol=RTOL,
                                           err_msg=k)
        np.testing.assert_array_equal(g[tag + "prefill/aux/unique_experts"],
                                      jref[tag + "prefill/aux/unique_experts"])
        np.testing.assert_allclose(g[tag + "prefill/aux/lb_loss"],
                                   jref[tag + "prefill/aux/lb_loss"],
                                   rtol=1e-6)
        for i in range(jax_get_config(MODEL).reduced().num_layers):
            for k in ("expert_idx", "dropped"):
                np.testing.assert_array_equal(
                    g[f"{tag}prefill/route{i}/{k}"], jref[f"{tag}route{i}/{k}"])


def test_model_train_step_matches_jax(ranks):
    """One step of the config's own optimizer (AdamW, warm-up schedule: lr
    3e-6 at step 1, eps 1e-8) at (4, 1): the metrics on every rank, and
    every new parameter against the reference's. AdamW's first step moves
    a weight by lr * g' / (|g'| + eps) (g' the clipped gradient, g times
    scale = min(1, 1 / grad_norm)) plus the weight decay, so a gradient
    error d the gradient test allows (GRAD_REL * max|g| + GRAD_FLOOR a
    leaf) moves it by up to lr * eps * scale * d / (|g'| + eps)^2: each
    weight is held within that, plus 1e-3 lr for the rest of the
    arithmetic and one float32 rounding of p + u (one unit in the last
    place of the new weight), and never beyond the step's 2 lr. Over 90 %
    of the weights have |g'| far enough above eps that their limit is
    under 0.01 lr."""
    _, got, jref = ranks
    tag = "model/4x1/"
    lr, eps = 3e-4 / 100, 1e-8
    for r in range(4):
        for k in ("loss", "ce", "lb", "grad_norm"):
            np.testing.assert_allclose(got[r][tag + "step/" + k],
                                       jref[tag + "step/" + k], rtol=1e-5,
                                       err_msg=k)
    scale = min(1.0, 1.0 / float(jref[tag + "step/grad_norm"]))
    keys = [k[len(tag + "step/p/"):] for k in jref
            if k.startswith(tag + "step/p/")]
    assert len(keys) > 10
    tight = total = 0
    for k in keys:
        ref_new = jref[tag + "step/p/" + k]
        g_ref = np.abs(jref[tag + "grad/" + k])
        d = scale * (GRAD_REL * float(g_ref.max()) + GRAD_FLOOR)
        limit = np.minimum(
            lr * (1e-3 + eps * d / (scale * g_ref + eps) ** 2), 2 * lr)
        excess = (np.abs(got[0][tag + "step/p/" + k] - ref_new)
                  - np.spacing(np.abs(ref_new)))
        assert float((excess - limit).max()) <= 0.0, k
        tight += int((limit < 1e-2 * lr).sum())
        total += limit.size
    assert tight > 0.9 * total


def test_model_adafactor_step_at_2x2_matches_jax(ranks):
    """One Adafactor step (lr 3e-6 at step 1) at (2, 2), where the routed
    and shared experts are cut in F over the model group: each rank sums
    the row statistic, its mean and the update's RMS over the slices the
    other model rank holds (`param_cuts`). The metrics on every rank, and
    every new parameter against the reference's within ADAFACTOR_TOL of lr
    beyond one float32 rounding of the new weight: the update is the
    gradient over the root of its factored second moment, clipped to unit
    RMS, so the gradient errors the gradient test allows (1e-5 of a leaf's
    largest) move it by a like share of lr."""
    _, got, jref = ranks
    tag = "model/2x2/step/"
    lr = 3e-4 / 100
    for r in range(4):
        for k in ("loss", "ce", "lb", "grad_norm"):
            np.testing.assert_allclose(got[r][tag + k], jref[tag + k],
                                       rtol=1e-5, err_msg=k)
    keys = [k for k in jref if k.startswith(tag + "p/")]
    assert len(keys) > 10
    for k in keys:
        ref_new = jref[k]
        excess = np.abs(got[0][k] - ref_new) - np.spacing(np.abs(ref_new))
        assert float(excess.max()) <= ADAFACTOR_TOL * lr, \
            (k, float(excess.max()) / lr)


@pytest.mark.parametrize("n_data,c_src", [(2, 3), (4, 1), (1, 40)])
def test_local_pack_matches_reference(n_data, c_src):
    """The send buffer, destination ranks, local expert ids, clamped slots
    and the keep mask equal the reference's exactly (c_src 1 and 3 force
    spills; 40 none)."""
    jcfg = jax_get_config("olmoe-1b-7b").reduced()
    tcfg = get_config("olmoe-1b-7b").reduced()
    rng = np.random.default_rng(9 + n_data)
    t = 12
    x = rng.standard_normal((t, tcfg.d_model)).astype(np.float32)
    idx = np.stack([rng.permutation(tcfg.num_experts)[:tcfg.experts_per_token]
                    for _ in range(t)]).astype(np.int32)
    jsend, jbook = j_local_pack(jcfg, jnp.asarray(x), jnp.asarray(idx),
                                n_data, c_src)
    tsend, tbook = _local_pack(tcfg, torch.from_numpy(x),
                               torch.from_numpy(idx), n_data, c_src)
    np.testing.assert_array_equal(tsend.numpy(), np.asarray(jsend))
    for g, r in zip(tbook, jbook):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert (c_src < 40) == (not bool(tbook[3].all()))
