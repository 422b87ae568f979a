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
`unique_experts_src`. A call that would need a gradient raises."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.distributed.expert_parallel import _local_pack as j_local_pack
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.distributed.expert_parallel import _local_pack
from test_torch_guards import torch_one_thread  # noqa: F401,E402 (autouse)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("mixtral-8x7b", "deepseek-moe-16b")   # the same names in both
T_TOKENS = 32
LAYOUTS = ((4, 1), (2, 2))
ATOL, RTOL = 3e-5, 1e-5

_RANKS = textwrap.dedent(r'''
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from repro_torch.configs import get_config
    from repro_torch.distributed import (make_expert_parallel_moe,
                                         shard_moe_params)
    from repro_torch.models import moe

    def _tensors(z, prefix):
        out = {}
        for key in z.files:
            if key.startswith(prefix):
                name = key[len(prefix):]
                if name.startswith("shared/"):
                    out.setdefault("shared", {})[name[7:]] = \
                        torch.from_numpy(z[key])
                else:
                    out[name] = torch.from_numpy(z[key])
        return out

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
                try:
                    ep(p_loc, x_loc.clone().requires_grad_())
                    raised = ""
                except NotImplementedError as err:
                    raised = str(err)
                res[tag + "grad_raised"] = torch.tensor(
                    "item 11" in raised)
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
    """The JAX references and the four ranks' results, by arch."""
    out_dir = tmp_path_factory.mktemp("ep_ranks")
    inputs, refs = {}, {}
    for i, arch in enumerate(ARCHS):
        p, x = _layer(arch, seed=40 + i)
        inputs.update(_flat(f"{arch}/p/", p))
        inputs[f"{arch}/x"] = x
        jcfg = jax_get_config(arch).reduced()
        y, aux = jmoe.apply_moe(jcfg, _jax(p), jnp.asarray(x),
                                capacity_policy="exact")
        refs[arch] = (np.asarray(y), {k: np.asarray(v)
                                      for k, v in aux.items()})
    np.savez(out_dir / "inputs.npz", **inputs)
    script = out_dir / "ranks.py"
    script.write_text(_RANKS)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, str(script), str(out_dir),
         ",".join(ARCHS),
         ",".join(f"{nd}x{nm}" for nd, nm in LAYOUTS)],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    got = [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(4)]
    return refs, got


def _tokens_of(rank, layout):
    """The token rows [lo, hi) the rank's data index holds."""
    nd, nm = layout
    t_loc = T_TOKENS // nd
    di = rank // nm
    return di * t_loc, (di + 1) * t_loc


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: f"{l[0]}x{l[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_matches_exact_apply_moe(ranks, arch, layout):
    refs, got = ranks
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
    refs, got = ranks
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
    refs, got = ranks
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


def test_dispatch_refuses_gradients(ranks):
    """The collectives carry no gradient: on every rank and layout a call
    whose input requires one raises NotImplementedError naming the
    ROADMAP item."""
    _, got = ranks
    for arch in ARCHS:
        for nd, nm in LAYOUTS:
            for r in range(4):
                assert bool(got[r][f"{arch}/{nd}x{nm}/grad_raised"])


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
