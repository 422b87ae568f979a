"""The port's checkpoints (`repro_torch.checkpoint`) on the CPU: trees
round-trip bit for bit with their containers and leaf types, a JAX tree
read back by the JAX package's checkpoint and converted equals the port's
round trip of the converted tree, training resumed from a checkpoint takes
the same step as an uninterrupted run, and `restore` keeps the port's
device rule (the card unless the caller asks for the CPU)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore as jrestore
from repro.checkpoint import save as jsave
from repro_torch import checkpoint
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.data import batch_iterator
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tT
from repro_torch.training import adamw, make_train_step
from repro_torch.training.optimizer import OptState
from test_torch_guards import torch_one_thread  # noqa: F401,E402 (autouse)

_INT_VIEW = {torch.bfloat16: torch.int16, torch.float32: torch.int32}


def _assert_same_tree(got, ref):
    """Same containers (dict, list, tuple kept apart), same python leaves,
    and every tensor leaf of the same dtype, shape and bits."""
    assert type(got) is type(ref)
    if isinstance(ref, dict):
        assert list(got) == list(ref)
        for k in ref:
            _assert_same_tree(got[k], ref[k])
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            _assert_same_tree(a, b)
    elif isinstance(ref, torch.Tensor):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert got.device.type == "cpu"
        view = _INT_VIEW.get(ref.dtype)
        if view is None:
            assert torch.equal(got, ref)
        else:
            assert torch.equal(got.view(view), ref.view(view))
    else:
        assert got == ref


def _round_trip(tmp_path, tree, name="ck.pt"):
    path = os.path.join(tmp_path, "sub", name)
    checkpoint.save(path, tree)
    assert not os.path.exists(path + ".tmp")
    return checkpoint.restore(path, device="cpu")


def test_reference_tree_round_trips_bit_exactly(tmp_path):
    """The JAX package's test tree (bf16, a nested tuple, a 0-d scalar),
    with a list, python leaves and the float32 bits of -0.0 and a NaN."""
    tree = {"a": torch.ones((3, 4), dtype=torch.bfloat16) * 1.5,
            "nested": ({"b": torch.arange(5, dtype=torch.int32)},),
            "scalar": torch.tensor(2.5, dtype=torch.float32),
            "list": [torch.tensor([-0.0, float("nan"), 1e-40]), 3, 0.5,
                     "name", None, True]}
    back = _round_trip(tmp_path, tree)
    _assert_same_tree(back, tree)
    assert back["scalar"].dim() == 0
    assert isinstance(back["nested"], tuple) and isinstance(back["list"],
                                                            list)


def test_int8_quantized_tree_round_trips(tmp_path):
    cfg = dataclasses.replace(get_config("mixtral-8x7b").reduced(),
                              dtype="bfloat16")
    params = tT.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    qparams = tmoe.quantize_transformer_experts(params)
    leaves = {t.dtype for t in jax.tree_util.tree_leaves(qparams)}
    assert {torch.int8, torch.bfloat16, torch.float32} <= leaves
    _assert_same_tree(_round_trip(tmp_path, qparams), qparams)


def test_a_view_is_saved_alone(tmp_path):
    big = torch.arange(1 << 16, dtype=torch.float32)
    path = os.path.join(tmp_path, "view.pt")
    checkpoint.save(path, {"head": big[:4]})
    assert os.path.getsize(path) < 4096
    _assert_same_tree(checkpoint.restore(path, device="cpu"),
                      {"head": big[:4].clone()})


def test_jax_checkpoint_converted_equals_the_ports_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    jtree = {"w": jnp.asarray(rng.normal(size=(4, 6)), jnp.bfloat16),
             "f": jnp.asarray(rng.normal(size=(3,)), jnp.float32),
             "layers": [{"i": jnp.arange(4, dtype=jnp.int32)},
                        {"q": jnp.asarray(rng.integers(-128, 128, (2, 5)),
                                          jnp.int8)}],
             "pair": (jnp.asarray(1.25, jnp.float32),
                      jnp.zeros((2, 2), jnp.bfloat16))}
    jpath = os.path.join(tmp_path, "ref.msgpack")
    jsave(jpath, jtree)
    from_jax = params_from_numpy(jax.device_get(jrestore(jpath)),
                                 device="cpu")
    converted = params_from_numpy(jax.device_get(jtree), device="cpu")
    _assert_same_tree(from_jax, converted)
    _assert_same_tree(_round_trip(tmp_path, converted), from_jax)


def test_training_resumed_from_a_checkpoint_takes_the_same_step(tmp_path):
    """(params, opt_state) saved after 2 steps and restored: the third
    step's parameters, optimizer state and metrics equal an uninterrupted
    run's bit for bit (the train step updates its state in place, so the
    checkpoint is a copy). Under PyTorch's deterministic algorithms: the
    CPU's embedding backward otherwise sums in a varying order, and two
    steps from one state differ in the last bits."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        _resume_and_compare(tmp_path)
    finally:
        torch.use_deterministic_algorithms(was)


def _resume_and_compare(tmp_path):
    cfg = dataclasses.replace(get_config("mixtral-8x7b").reduced(),
                              vocab_size=128, num_layers=1)
    init_state, step = make_train_step(cfg, optimizer=adamw(2e-3))
    state = init_state(torch.Generator().manual_seed(0), device="cpu")
    it = batch_iterator("all-3", 4, 32, vocab=cfg.vocab_size, seed=0,
                        prompt_len=16)
    for _ in range(2):
        state, _ = step(state, next(it))
    path = os.path.join(tmp_path, "train.pt")
    checkpoint.save(path, state)
    batch = next(it)
    straight, m_straight = step(state, batch)

    params, opt = checkpoint.restore(path, device="cpu")
    assert isinstance(opt, tuple) and opt[0] == 2
    resumed, m_resumed = step((params, OptState(*opt)), batch)
    assert resumed[1].step == straight[1].step == 3
    _assert_same_tree(resumed[0], straight[0])
    _assert_same_tree(tuple(resumed[1]), tuple(straight[1]))
    assert {k: float(v) for k, v in m_resumed.items()} == \
        {k: float(v) for k, v in m_straight.items()}


def test_restore_without_a_device_refuses_a_machine_without_a_card(
        tmp_path, monkeypatch):
    path = os.path.join(tmp_path, "ck.pt")
    checkpoint.save(path, {"a": torch.ones(2)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        checkpoint.restore(path)
    _assert_same_tree(checkpoint.restore(path, device="cpu"),
                      {"a": torch.ones(2)})


def test_save_refuses_a_leaf_it_cannot_restore(tmp_path):
    with pytest.raises(TypeError, match="ndarray"):
        checkpoint.save(os.path.join(tmp_path, "ck.pt"),
                        {"a": np.ones(2)})
