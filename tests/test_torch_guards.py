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
    for name in ("serving.engine", "serving.telemetry", "core.planner",
                 "kernels.moe_gmm.ops", "kernels.moe_gmm.quant",
                 "kernels.flash_attention.ops", "training.train",
                 "training.optimizer", "data.pipeline", "data.workloads",
                 "launch.train", "models.rwkv", "kernels.rwkv_scan.ops",
                 "serving.scheduler", "serving.load", "launch.serve",
                 "sim.simulator", "sim.tasks"):
        assert f"repro_torch.{name}" in res["modules"]
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


def test_batched_engine_without_device_refuses_a_machine_without_a_card(
        monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving import BatchedEngine

    _no_card(monkeypatch)
    cfg = get_config("mixtral-8x7b").reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        BatchedEngine(cfg, params)
    eng = BatchedEngine(cfg, params, device="cpu", max_batch=2, max_len=64,
                        temperature=0.0)
    assert len(eng.generate([1, 2, 3, 1, 2, 3], max_new=4).tokens) == 4
    params["embed"]["embedding"] = params["embed"]["embedding"].to("meta")
    with pytest.raises(ValueError, match="params lie on"):
        BatchedEngine(cfg, params, device="cpu")


def test_serve_launcher_without_device_refuses_a_machine_without_a_card(
        monkeypatch):
    from repro_torch.launch import serve

    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "mixtral-8x7b", "--requests", "1",
                    "--max-new", "4"])


def test_serve_launcher_on_cpu_serves_and_names_the_h100(capsys):
    from repro_torch.launch import serve

    assert serve.main(["--arch", "mixtral-8x7b", "--device", "cpu",
                       "--requests", "3", "--max-new", "8",
                       "--policy", "k2"]) == 0
    out = capsys.readouterr().out
    assert "h100-sxm" in out and "on cpu" in out
    assert "tpu" not in out.lower() and "v5e" not in out.lower()
    # the first token comes from the prefill, the other 7 from decode
    assert [line.split("out=")[1].split()[0] for line in out.splitlines()
            if "out=" in line] == ["7", "7", "7"]


def test_engines_refuse_an_encoder_output():
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving import (BatchedEngine, NGramDrafter,
                                     ServingEngine)

    cfg = get_config("mixtral-8x7b").reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    enc = torch.zeros((1, 4, cfg.d_model))
    single = ServingEngine(cfg, params, NGramDrafter(), device="cpu",
                           max_len=32)
    batched = BatchedEngine(cfg, params, device="cpu", max_batch=1,
                            max_len=32)
    for call in (lambda: single.generate([1, 2, 3], 2, enc_out=enc),
                 lambda: batched.join([1, 2, 3], 2, enc_out=enc),
                 lambda: batched.generate([1, 2, 3], 2, enc_out=enc)):
        with pytest.raises(NotImplementedError, match="Whisper"):
            call()
    assert batched.free_slots == [0]
    assert len(batched.generate([1, 2, 3], 2, enc_out=None).tokens) == 2


def test_int8_model_pass_on_cpu_launches_no_kernel():
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as T

    cfg = get_config("mixtral-8x7b").reduced()
    params = moe_mod.quantize_transformer_experts(
        T.init_params(cfg, torch.Generator().manual_seed(2), device="cpu"))
    K.reset_launch_counts()
    cache = T.init_cache(cfg, 2, 32, device="cpu", per_row=True)
    toks = torch.tensor([[4, 5, 6], [7, 8, 9]], dtype=torch.int32)
    for packed in (False, True):
        T.decode_step(cfg, params, cache, toks, moe_packed=packed,
                      token_mask=torch.ones_like(toks, dtype=torch.bool))
    assert K.launch_counts() == {n: 0 for n in K.KERNELS}


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
    with pytest.raises(KeyError):
        get_config("whisper-large-v3")
    cfg = dataclasses.replace(get_config("olmoe-1b-7b").reduced(),
                              use_mla=True)
    with pytest.raises(NotImplementedError):
        T.init_cache(cfg, 1, 8, device="cpu")
    # a pattern stack whose "A" layers are MoE layers is not ported (the
    # port's pattern stacks are RecurrentGemma's, with dense FFNs)
    cfg = dataclasses.replace(get_config("olmoe-1b-7b").reduced(),
                              layer_pattern="RRA", num_layers=3)
    with pytest.raises(NotImplementedError):
        T.init_cache(cfg, 1, 8, device="cpu")
    # an RWKV-6 stack serves but does not train: no backward kernel
    cfg = get_config("rwkv6-3b").reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    with pytest.raises(NotImplementedError, match="RWKV"):
        T.train_forward(cfg, params, torch.zeros((1, 4), dtype=torch.int32))


def test_train_launcher_refuses_rwkv():
    from repro_torch.launch import train

    with pytest.raises(NotImplementedError, match="RWKV"):
        train.main(["--arch", "rwkv6-3b", "--device", "cpu", "--steps", "1",
                    "--batch", "1", "--seq", "8"])


def test_train_launcher_refuses_recurrentgemma():
    """A RecurrentGemma pattern stack serves but does not train: no
    backward kernel exists for the RG-LRU recurrence."""
    from repro_torch.launch import train

    with pytest.raises(NotImplementedError, match="RecurrentGemma"):
        train.main(["--arch", "recurrentgemma-9b", "--device", "cpu",
                    "--steps", "1", "--batch", "1", "--seq", "8"])


def test_rwkv_pass_on_cpu_launches_no_kernel():
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = get_config("rwkv6-3b").reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(3),
                           device="cpu")
    K.reset_launch_counts()
    cache = T.init_cache(cfg, 2, 32, device="cpu", per_row=True)
    toks = torch.tensor([[4, 5, 6], [7, 8, 9]], dtype=torch.int32)
    _, cache, _, staged = T.decode_step(cfg, params, cache, toks)
    assert staged["wkv"].shape == (2, 4, 2, 8, 32, 32)
    assert K.launch_counts() == {n: 0 for n in K.KERNELS}
