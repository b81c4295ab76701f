"""The port's Ulysses sequence parallelism (deepspeed_tpu_torch/sequence/
layer.py: ``single_all_to_all``, ``DistributedAttention``,
``ulysses_attention``) held against the JAX package's on CPU: gloo worlds
of sp = 2 and 4 processes (spawned once each) against JAX
``ulysses_attention`` on the virtual mesh and against dense attention,
forward and gradients of the same numpy inputs, at the tolerances of
tests/unit/test_sequence.py (forward rtol 2e-5 / atol 2e-6, gradients
rtol 3e-4 / atol 3e-5)."""

import numpy as np
import pytest

import jax

from deepspeed_tpu.sequence import ulysses_attention as julysses
from deepspeed_tpu.utils import groups as jgroups
from test_torch_dist_worker import run_world
from test_torch_ring_attention import (_check, _dense, _gathered,
                                       _jax_fwd_grads, _qkv)

SP = (2, 4)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {sp: run_world("ulysses", sp, _qkv(seed=3),
                          tmp_path_factory.mktemp(f"ulysses{sp}"))
            for sp in SP}


def _jax_ulysses(sp, x):
    jgroups.reset()
    topo = jgroups.initialize(jgroups.TopologyConfig(seq_parallel_size=sp),
                              devices=jax.devices()[:sp])
    with jax.set_mesh(topo.mesh):
        return _jax_fwd_grads(jax.jit(
            lambda a, b, c: julysses(a, b, c, topo.mesh)), x)


@pytest.mark.parametrize("sp", SP)
def test_distributed_attention_matches_jax_and_dense(worlds, sp):
    x = _qkv(seed=3)
    got = _gathered(worlds[sp], "local")
    _check(got, _jax_ulysses(sp, x), f"sp={sp} vs jax")
    _check(got, _jax_fwd_grads(lambda a, b, c: _dense(a, b, c, True), x),
           f"sp={sp} vs dense")


@pytest.mark.parametrize("sp", SP)
def test_ulysses_attention_global_entry(worlds, sp):
    want = _jax_ulysses(sp, _qkv(seed=3))["o"]
    for o in worlds[sp]:
        np.testing.assert_allclose(o["res"]["sharded"], want, rtol=2e-5,
                                   atol=2e-6)


def test_single_all_to_all_round_trip():
    """Without a world the all-to-all is the identity, and its gradient
    passes through."""
    import torch
    from deepspeed_tpu_torch.sequence import single_all_to_all
    from deepspeed_tpu_torch.utils import groups
    groups.reset()
    x = torch.randn(2, 6, 4, 3, requires_grad=True)
    y = single_all_to_all(x, 2, 1, "seq")
    assert torch.equal(y, x)
    (g,) = torch.autograd.grad(y.sum() * 2, x)
    assert torch.equal(g, torch.full_like(x, 2.0))
