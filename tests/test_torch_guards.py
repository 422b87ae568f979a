"""Guards of the port: it never imports JAX or the JAX package, its entry
points refuse to run on the CPU unless asked to, and its kernel wrappers
launch nothing for CPU tensors."""

import json
import math
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
                 "sim.simulator", "sim.tasks", "core.residency",
                 "checkpoint", "checkpoint.checkpoint", "serving.drafter",
                 "configs.stablelm_1_6b", "configs.stablelm_3b",
                 "configs.minitron_4b", "configs.kimi_k2_1t_a32b",
                 "models.mla", "configs.deepseek_v2_236b",
                 "configs.chatglm3_6b", "configs.qwen2_vl_7b",
                 "configs.whisper_large_v3", "models.rope",
                 "models.attention", "distributed",
                 "distributed.expert_parallel", "models.rglru",
                 "models.transformer", "kernels.linear_scan.ops",
                 "training"):
        assert f"repro_torch.{name}" in res["modules"]
    assert res["bad"] == []


@pytest.fixture(autouse=True, scope="module")
def torch_one_thread():
    """torch's CPU ops on one thread while a module's tests run, restored
    after. The tests run small models whose many small ops run several
    times slower (the whole suite 2.5x) when the thread pools of the test
    workers, each as wide as the host, contend for its cores. Every
    `test_torch_*` module but the card's imports this fixture."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def test_draft_model_drafter_without_device_refuses_a_machine_without_a_card(
        monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving import DraftModelDrafter

    _no_card(monkeypatch)
    cfg = get_config("stablelm-1.6b").reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        DraftModelDrafter(cfg, params)
    drafter = DraftModelDrafter(cfg, params, max_len=32, temperature=0.0,
                                device="cpu")
    drafts, probs = drafter.propose([1, 2, 3], 3)
    assert len(drafts) == 3 and probs is None and drafter.synced == 3
    params["embed"]["embedding"] = params["embed"]["embedding"].to("meta")
    with pytest.raises(ValueError, match="params lie on"):
        DraftModelDrafter(cfg, params, device="cpu")


@pytest.mark.parametrize("arch", ["stablelm-3b", "minitron-4b",
                                  "kimi-k2-1t-a32b", "deepseek-v2-236b"])
def test_serve_launcher_takes_the_new_configs(arch, capsys):
    from repro_torch.launch import serve

    assert serve.main(["--arch", arch, "--device", "cpu", "--requests", "1",
                       "--max-new", "4"]) == 0
    assert f"{arch}-reduced" in capsys.readouterr().out


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


def test_trainer_refuses_an_encoder_output():
    """Whisper trains on its encoder output: a training step with `enc_out`
    gives a finite loss and updates the cross-attention's weights, and
    the launcher trains it on the CPU (zero encoder states, as the
    reference's launcher feeds). What is still refused: a prefill without
    the encoder output raises ValueError, as the training pass does."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import transformer as T
    from repro_torch.training import make_train_step

    cfg = get_config("whisper-large-v3").reduced()
    init, step = make_train_step(cfg)
    state = init(torch.Generator().manual_seed(0), device="cpu")
    wk = state[0]["blocks"]["xattn"]["wk"].clone()
    toks = torch.zeros((1, 4), dtype=torch.int32)
    enc = torch.randn((1, cfg.encoder_len, cfg.encoder_d_model),
                      generator=torch.Generator().manual_seed(1))
    state, m = step(state, {"tokens": toks, "labels": toks, "enc_out": enc})
    assert torch.isfinite(m["loss"])
    assert not torch.equal(state[0]["blocks"]["xattn"]["wk"], wk)
    with pytest.raises(ValueError, match="enc_out"):
        T.prefill(cfg, state[0], toks, T.init_cache(cfg, 1, 8, device="cpu"))
    with pytest.raises(ValueError, match="enc_out"):
        step(state, {"tokens": toks, "labels": toks})
    assert train.main(["--arch", "whisper-large-v3", "--device", "cpu",
                       "--steps", "1", "--batch", "1", "--seq", "8"]) == 0


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
    """An unknown name raises KeyError. A pattern stack with Multi-head
    Latent Attention in its "A" layers is refused: the reference's pattern
    loop reads `k`/`v` caches for every "A" layer, so its prefill of such
    a stack fails (KeyError 'k', checked here), and the port refuses the
    stack whole. (A pattern stack whose "A" layers are MoE layers runs in
    both: test_torch_rglru.py.)"""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_get_config
    from repro.models import transformer as jT
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    with pytest.raises(KeyError):
        get_config("whisper-tiny")
    kw = dict(layer_pattern="RRA", num_layers=3)
    jcfg = dataclasses.replace(jax_get_config("deepseek-v2-236b").reduced(),
                               **kw)
    jp = jT.init_params(jcfg, jax.random.PRNGKey(0))
    with pytest.raises(KeyError, match="'k'"):
        jT.prefill(jcfg, jp, jnp.zeros((1, 4), jnp.int32),
                   jT.init_cache(jcfg, 1, 8))
    cfg = dataclasses.replace(get_config("deepseek-v2-236b").reduced(), **kw)
    assert cfg.use_mla and cfg.layer_kinds() == ("R", "R", "A")
    with pytest.raises(NotImplementedError):
        T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(NotImplementedError):
        T.init_cache(cfg, 1, 8, device="cpu")
    with pytest.raises(NotImplementedError):
        T.train_forward(cfg, T.init_params(
            get_config("olmoe-1b-7b").reduced(),
            torch.Generator().manual_seed(0), device="cpu"),
            torch.zeros((1, 4), dtype=torch.int32))


def _launcher_trains_on_cpu_without_a_launch(arch, capsys):
    """One CPU step of the train launcher on `arch`: a finite loss, and no
    kernel launched (the two recurrences' backward kernels counted)."""
    from repro_torch import kernels as K
    from repro_torch.launch import train

    K.reset_launch_counts()
    assert train.main(["--arch", arch, "--device", "cpu", "--steps", "1",
                       "--batch", "1", "--seq", "8"]) == 0
    losses = [float(line.split()[3]) for line in
              capsys.readouterr().out.splitlines() if line.startswith("step")]
    assert len(losses) == 1 and all(map(math.isfinite, losses))
    assert "rwkv_scan_bwd" in K.KERNELS and "linear_scan_bwd" in K.KERNELS
    assert K.launch_counts() == {n: 0 for n in K.KERNELS}


def test_train_launcher_refuses_rwkv(capsys):
    """An RWKV-6 stack trains (the refusal this test held is lifted): the
    WKV recurrence's backward runs its plain version on the CPU."""
    _launcher_trains_on_cpu_without_a_launch("rwkv6-3b", capsys)


def test_train_launcher_refuses_recurrentgemma(capsys):
    """A RecurrentGemma pattern stack trains (the refusal this test held is
    lifted): the RG-LRU recurrence's backward runs its plain version on
    the CPU."""
    _launcher_trains_on_cpu_without_a_launch("recurrentgemma-9b", capsys)


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
