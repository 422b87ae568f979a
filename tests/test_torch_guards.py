"""Guards of the port: it never imports JAX or the JAX package, its entry
points refuse to run on the CPU unless asked to, and its kernel wrappers
launch nothing for CPU tensors."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, json, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke  # noqa: F401  (its imports; main() runs only as a script)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_and_chip_smoke_import_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch.serving.engine" in res["modules"]
    assert "repro_torch.kernels.moe_gmm.ops" in res["modules"]
    assert res["bad"] == []


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_without_device_refuse_a_machine_without_a_card(
        monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.models import transformer as T
    from repro_torch.serving import NGramDrafter, ServingEngine

    _no_card(monkeypatch)
    cfg = get_config("olmoe-1b-7b").reduced()
    with pytest.raises(RuntimeError, match="cuda"):
        T.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="cuda"):
        T.init_cache(cfg, 1, 16)
    with pytest.raises(RuntimeError, match="cuda"):
        params_from_numpy({})
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        ServingEngine(cfg, params, NGramDrafter())
    # asked for explicitly, the CPU works
    eng = ServingEngine(cfg, params, NGramDrafter(), device="cpu",
                        max_len=64, temperature=0.0)
    assert len(eng.generate([1, 2, 3, 1, 2, 3], max_new=4).tokens) == 4


def test_engine_refuses_params_on_another_device():
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving import NGramDrafter, ServingEngine

    cfg = get_config("mixtral-8x7b").reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    params["embed"]["embedding"] = params["embed"]["embedding"].to("meta")
    with pytest.raises(ValueError, match="params lie on"):
        ServingEngine(cfg, params, NGramDrafter(), device="cpu")


def test_model_pass_on_cpu_launches_no_kernel():
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = get_config("olmoe-1b-7b").reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(1),
                           device="cpu")
    K.reset_launch_counts()
    cache = T.init_cache(cfg, 1, 32, device="cpu")
    toks = torch.tensor([[4, 5, 6, 7]], dtype=torch.int32)
    _, cache, _ = T.prefill(cfg, params, toks, cache)
    for packed in (False, True):
        T.decode_step(cfg, params, cache, toks[:, :3], moe_packed=packed)
    assert K.launch_counts() == {n: 0 for n in K.KERNELS}


def test_unported_configurations_raise():
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    with pytest.raises(KeyError):
        get_config("stablelm-1.6b")
    cfg = dataclasses.replace(get_config("olmoe-1b-7b").reduced(),
                              use_mla=True)
    with pytest.raises(NotImplementedError):
        T.init_cache(cfg, 1, 8, device="cpu")
