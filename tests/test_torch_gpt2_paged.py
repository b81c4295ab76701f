"""The GPT-2 family's paged serving programs (GPT-2, OPT, GPT-Neo:
``apply_paged_prefill`` / ``chunk`` / ``decode`` / ``verify`` of
deepspeed_tpu_torch/models/gpt2.py) held against the JAX programs on CPU
at the ``*_TINY`` presets, fp32, with randomized LayerNorms and biases
(the init's ones and zeros would hide a leaf wired wrong), the projections
at 4x the init's scale, and random pools: logits and every pool within
1e-5. The prompt (75 tokens) is longer than GPT-Neo's window-64 layer,
and a decode and a verify run past ``max_seq_len - 1`` (the learned
position clamps to the last ``wpe`` row). The JAX side runs its dense
programs (``paged_kernel`` off); the port's kernel wrappers take their
plain versions on CPU tensors, which test_torch_paged_attention.py holds
against the JAX Pallas kernels. Also: the presets and the tree mirror
JAX's; the quantized programs on the fused path (K7's plain version
against the JAX ``wq_matmul`` in interpret mode) and converted quantized
trees, int8 and int4."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu.models as jmodels
import deepspeed_tpu_torch.models as tmodels
from deepspeed_tpu.ops import int8_weights as jiw
from deepspeed_tpu_torch.models import (gpt2_moe_params_from_numpy,
                                        gpt2_params_from_numpy)
from deepspeed_tpu_torch.ops import int8_weights as iw

PROG_TOL = dict(rtol=1e-5, atol=1e-5)
NB, BS = 40, 8
BITS = {"int8": 8, "int4": 4}

# family: (class name, module, TINY name, presets name)
FAMILIES = {
    "gpt2": ("GPT2", "gpt2", "GPT2_TINY", "PRESETS"),
    "opt": ("OPT", "opt", "OPT_TINY", "OPT_PRESETS"),
    "gpt_neo": ("GPTNeo", "gpt_neo", "GPTNEO_TINY", "GPTNEO_PRESETS"),
}
SCALES = ("ln1_scale", "ln2_scale", "lnf_scale")
SHIFTS = ("ln1_bias", "ln2_bias", "lnf_bias", "bqkv", "bo", "bup", "bdown")
# the projections drawn at 4x the init's std, so that attention and the MLP
# (not the tied embedding's echo of the input token) decide the argmax
WEIGHTS = ("wqkv", "wo", "wup", "wdown")
GAIN = 4.0


def family(name):
    """(JAX class, port class, JAX module, port module)."""
    cls, mod, _, _ = FAMILIES[name]
    jmod = __import__(f"deepspeed_tpu.models.{mod}", fromlist=[cls])
    tmod = __import__(f"deepspeed_tpu_torch.models.{mod}", fromlist=[cls])
    return getattr(jmod, cls), getattr(tmod, cls), jmod, tmod


def randomize(tree, seed=0):
    """The tree with every LayerNorm scale at 1 + 0.1 N(0, 1), every
    shift / bias at 0.1 N(0, 1) (a numpy seed, in the tree's order) and
    the projections times GAIN."""
    rs = np.random.RandomState(seed)

    def walk(t):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in SCALES:
                out[k] = (1 + 0.1 * rs.standard_normal(v.shape)).astype(
                    np.float32)
            elif k in SHIFTS:
                out[k] = (0.1 * rs.standard_normal(v.shape)).astype(
                    np.float32)
            elif k in WEIGHTS:
                out[k] = (GAIN * np.asarray(v)).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out
    return walk(tree)


def pair(name, **over):
    """The same fp32 model in both packages: (JAX model, its randomized
    tree as jnp, the port's model loaded from it, the tree as numpy)."""
    jcls, tcls, jmod, tmod = family(name)
    tiny = FAMILIES[name][2]
    over = dict(dtype="float32", **over)
    jm = jcls(dataclasses.replace(getattr(jmod, tiny), **over))
    tree = randomize(jax.tree.map(np.asarray, jm.init(jax.random.key(0))))
    pm = tcls(dataclasses.replace(getattr(tmod, tiny), **over),
              device="cpu", dtype=torch.float32)
    pm.load_state_dict(gpt2_params_from_numpy(tree, "cpu", torch.float32))
    return jm, jax.tree.map(jnp.asarray, tree), pm, tree


def _flat(tree):
    out = {k: v for k, v in tree.items() if k != "blocks"}
    out.update({f"blocks.{k}": v for k, v in tree["blocks"].items()})
    return out


@pytest.mark.parametrize("name", list(FAMILIES))
def test_presets_and_tree_mirror_jax(name):
    """Every preset's config, ``num_params`` and ``flops_per_token`` are
    JAX's; the exports match the JAX ``models`` package's; the randomized
    tree loads with no renaming, leaf for leaf."""
    cls, mod, tiny, presets = FAMILIES[name]
    jcls, tcls, jmod, tmod = family(name)
    jp, tp = getattr(jmod, presets), getattr(tmod, presets)
    assert set(tp) == set(jp)
    for key, cfg in jp.items():
        assert dataclasses.asdict(tp[key]) == dataclasses.asdict(cfg), key
        assert tp[key].num_params() == cfg.num_params(), key
        assert tp[key].flops_per_token() == cfg.flops_per_token(), key
    assert getattr(tmodels, cls) is tcls
    if name != "gpt2":
        assert getattr(tmodels, presets) is tp
        assert getattr(jmodels, presets) is jp
    _, _, pm, tree = pair(name)
    sd = pm.state_dict()
    flat = _flat(tree)
    assert set(sd) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(sd[k].numpy(), v)


def test_constructor_checks_match_jax():
    """OPT refuses a non-ReLU FFN as JAX's does; a window tuple of the
    wrong length raises; the port's GPT-2 takes per-layer windows now."""
    from deepspeed_tpu.models.opt import OPT as JOPT
    from deepspeed_tpu_torch.models.opt import OPT_TINY
    bad = dataclasses.replace(OPT_TINY, activation="gelu")
    with pytest.raises(ValueError, match="ReLU"):
        JOPT(bad)
    with pytest.raises(ValueError, match="ReLU"):
        tmodels.OPT(bad, device="cpu")
    with pytest.raises(ValueError, match="attn_layer_windows"):
        tmodels.GPT2(dataclasses.replace(tmodels.GPT2_TINY,
                                         attn_layer_windows=(0,)),
                     device="cpu")
    m = tmodels.GPT2(dataclasses.replace(tmodels.GPT2_TINY,
                                         attn_layer_windows=(0, 16)),
                     device="cpu")
    assert [m._window(i) for i in range(2)] == [0, 16]


def _pools(jm, pm, rs):
    """The same random pools on both sides."""
    jc = jm.init_paged_cache(NB, BS, dtype=jnp.float32)
    pc = pm.init_paged_cache(NB, BS)
    assert tuple(pc["k"][0].shape) == tuple(jc["k"][0].shape)
    for key in ("k", "v"):
        for i in range(len(pc[key])):
            arr = rs.standard_normal(pc[key][i].shape).astype(np.float32)
            pc[key][i].copy_(torch.from_numpy(arr))
            jc[key][i] = jnp.asarray(arr)
    return jc, pc


def _close(got, want, tag, tol=PROG_TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               err_msg=tag, **tol)


def _check_pools(jc, pc, tag, tol=PROG_TOL):
    for key in ("k", "v"):
        for a, b in zip(jc[key], pc[key]):
            _close(b.numpy(), a, f"{tag} pool {key}", tol)


def run_programs(jm, params, pm, tag, tol=PROG_TOL, verify=True):
    """prefill (75 of 80 tokens) -> chunk (13 more, across a block) ->
    decode (slot 0 at 88; slot 1 at 130, past max_seq_len - 1 = 127) ->
    verify (3 tokens a slot; slot 1's last positions clamp), each against
    the JAX program: logits and every pool."""
    rs = np.random.RandomState(1)
    jc, pc = _pools(jm, pm, rs)
    V = jm.config.vocab_size
    prompt = rs.randint(0, V, (88,)).astype(np.int32)
    seq0 = np.arange(3, 20, dtype=np.int32)          # 17 blocks
    seq1 = np.arange(20, 37, dtype=np.int32)

    T0, Tp = 75, 80
    ids = np.zeros((1, Tp), np.int32)
    ids[0, :T0] = prompt[:T0]
    tb = np.zeros((Tp,), np.int32)
    to = np.zeros((Tp,), np.int32)
    tb[:T0] = seq0[np.arange(T0) // BS]
    to[:T0] = np.arange(T0) % BS
    jl, jc = jm.apply_paged_prefill(params, jnp.asarray(ids), jc,
                                    jnp.asarray(tb), jnp.asarray(to),
                                    jnp.int32(T0))
    pl_, pc = pm.apply_paged_prefill(torch.from_numpy(ids), pc,
                                     torch.from_numpy(tb),
                                     torch.from_numpy(to), T0)
    _close(pl_.numpy(), jl, f"{tag} prefill", tol)
    _check_pools(jc, pc, f"{tag} prefill", tol)

    C, start, tl = 16, 75, 13
    ids = np.zeros((1, C), np.int32)
    ids[0, :tl] = prompt[start:start + tl]
    tb = np.zeros((C,), np.int32)
    to = np.zeros((C,), np.int32)
    pos = start + np.arange(tl)
    tb[:tl] = seq0[pos // BS]
    to[:tl] = pos % BS
    jl, jc = jm.apply_paged_chunk(
        params, jnp.asarray(ids), jc, jnp.asarray(tb), jnp.asarray(to),
        jnp.int32(start), jnp.int32(tl), jnp.asarray(seq0))
    pl_, pc = pm.apply_paged_chunk(
        torch.from_numpy(ids), pc, torch.from_numpy(tb),
        torch.from_numpy(to), start, tl, torch.from_numpy(seq0))
    _close(pl_.numpy(), jl, f"{tag} chunk", tol)
    _check_pools(jc, pc, f"{tag} chunk", tol)

    tables = np.stack([seq0, seq1])
    tokens = np.array([int(np.argmax(np.asarray(jl)[0])), 4], np.int32)
    lengths = np.array([88, 130], np.int32)
    jl, jc = jm.apply_paged_decode(params, jnp.asarray(tokens),
                                   jnp.asarray(lengths), jc,
                                   jnp.asarray(tables))
    pl_, pc = pm.apply_paged_decode(torch.from_numpy(tokens),
                                    torch.from_numpy(lengths), pc,
                                    torch.from_numpy(tables))
    _close(pl_.numpy(), jl, f"{tag} decode", tol)
    _check_pools(jc, pc, f"{tag} decode", tol)
    if not verify:
        return

    vt = rs.randint(0, V, (2, 3)).astype(np.int32)
    lengths = np.array([89, 126], np.int32)
    jl, jc = jm.apply_paged_verify(params, jnp.asarray(vt),
                                   jnp.asarray(lengths), jc,
                                   jnp.asarray(tables))
    pl_, pc = pm.apply_paged_verify(torch.from_numpy(vt), lengths, pc,
                                    torch.from_numpy(tables))
    _close(pl_.numpy(), jl, f"{tag} verify", tol)
    _check_pools(jc, pc, f"{tag} verify", tol)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_paged_programs_match_jax(name):
    jm, params, pm, _ = pair(name)
    jm._paged_kernel = False          # the JAX dense programs
    run_programs(jm, params, pm, name)


def test_position_clamp_reads_the_last_row():
    """A decode at or past max_seq_len embeds with the last ``wpe`` row,
    the same logits as at max_seq_len - 1 over the same cache."""
    _, _, pm, _ = pair("gpt2")
    rs = np.random.RandomState(4)
    pc = pm.init_paged_cache(NB, BS)
    for p in pc["k"] + pc["v"]:
        p.copy_(torch.from_numpy(rs.standard_normal(p.shape).astype(
            np.float32)))
    table = torch.arange(3, 20, dtype=torch.int32)[None]
    tok = torch.tensor([7], dtype=torch.int32)
    x = {n: pm._embed_at(tok[:, None], torch.tensor([[n]]))
         for n in (127, 128, 200)}
    assert torch.equal(x[127], x[128]) and torch.equal(x[127], x[200])
    logits, _ = pm.apply_paged_decode(tok, torch.tensor([130]), pc, table)
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_programs_match_jax(mode):
    """GPT-2 on the fused path (``wup`` / ``wdown`` kept quantized into
    K7; ``wqkv`` dequantized a layer at a time): prefill, chunk and
    decode against the JAX programs over the JAX ``quantize_tree``, loaded
    into the port through ``gpt2_params_from_numpy`` (no renaming)."""
    jm, _, pm0, tree = pair("gpt2")
    jm._paged_kernel = False
    jm._weight_quant_fused = True
    qtree = jax.tree.map(np.asarray, jiw.quantize_tree(tree,
                                                       bits=BITS[mode]))
    pm = tmodels.GPT2(pm0.config, device="cpu", dtype=torch.float32)
    pm.load_state_dict(gpt2_params_from_numpy(qtree, "cpu",
                                              torch.float32))
    assert pm.weight_quant == mode
    assert set(pm.qblocks) == {"wqkv", "wup", "wdown"}
    own = tmodels.GPT2(pm0.config, device="cpu", dtype=torch.float32)
    own.load_state_dict(gpt2_params_from_numpy(tree, "cpu", torch.float32))
    own.quantize_(mode)
    for k, w in pm.qblocks.items():   # the port's own rule, bitwise
        assert torch.equal(w.q, own.qblocks[k].q), k
        assert torch.equal(w.scale, own.qblocks[k].scale), k
    pm._weight_quant_fused = True
    assert iw.is_quantized(pm._w("wup", 1))
    assert not iw.is_quantized(pm._w("wqkv", 1))
    run_programs(jm, jax.tree.map(jnp.asarray, qtree), pm, f"gpt2 {mode}",
                 verify=False)


def test_gpt2_moe_refuses_quantized_leaves():
    from deepspeed_tpu.models.gpt2_moe import GPT2MoE as JMoE
    from deepspeed_tpu.models.gpt2_moe import GPT2MoEConfig as JMoECfg
    jm = JMoE(JMoECfg(n_layer=2, n_head=4, d_model=128, max_seq_len=32,
                      vocab_size=128, num_experts=2, dtype="float32"))
    tree = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    qtree = jiw.quantize_tree(tree)
    # quantized leaves, refused before GPT2MoE served, now load nested
    # under moe (test_torch_gpt2_moe_paged.py serves them)
    state = gpt2_moe_params_from_numpy(qtree, "cpu", torch.float32)
    assert {k for k, v in state.items() if iw.is_quantized(v)} == {
        "blocks.wqkv", "blocks.moe.wi", "blocks.moe.wo"}
    from deepspeed_tpu_torch.models import GPT2MoE, GPT2MoEConfig
    pm = GPT2MoE(GPT2MoEConfig(**jm.config.__dict__), device="cpu",
                 dtype=torch.float32)
    pm.load_state_dict(state)
    assert set(pm.qblocks) == {"wqkv", "moe.wi", "moe.wo"}
    np.testing.assert_array_equal(pm.qblocks["moe.wi"].q.numpy(),
                                  np.asarray(qtree["blocks"]["moe"]["wi"].q))
