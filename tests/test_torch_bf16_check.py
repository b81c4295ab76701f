"""The bf16 check that chip_smoke.py holds the Hopper kernels to, tried on
the CPU with the plain versions at long rows (thousands of keys, outputs
of a few hundredths): a correct bf16 computation passes it, and an output
with half its KV blocks dropped fails it."""

import numpy as np
import pytest
import torch

import chip_smoke
from deepspeed_tpu_torch.ops.cuda import paged_attention as pa

B, H, D, BS, MB = 4, 4, 128, 64, 32


def _bf16_valued(rs, shape):
    """fp32 tensor whose values are exactly bf16 (the kernels' inputs)."""
    return torch.from_numpy(rs.standard_normal(shape).astype(np.float32)).to(
        torch.bfloat16).float()


def _decode_inputs():
    rs = np.random.RandomState(0)
    NB = 1 + B * MB
    q = _bf16_valued(rs, (B, H, D))
    k = _bf16_valued(rs, (NB, H, BS, D))
    v = _bf16_valued(rs, (NB, H, BS, D))
    tables = torch.from_numpy(
        rs.permutation(np.arange(1, NB)).reshape(B, MB).astype(np.int32))
    lengths = torch.from_numpy(rs.randint(1024, MB * BS, B).astype(np.int32))
    return q, k, v, tables, lengths


@pytest.mark.parametrize("program", ["decode", "chunk"])
def test_plain_bf16_passes(program):
    q, k, v, tables, lengths = _decode_inputs()
    if program == "decode":
        plain = pa.paged_decode_attention_reference
        args = (tables, lengths)
    else:
        plain = pa.paged_chunk_attention_reference
        q = q.reshape(B * H, 1, D).expand(B * H, H, D).contiguous()
        args = (tables[0], 1000, B * H)
    ref = plain(q, k, v, *args)
    out = plain(*(t.to(torch.bfloat16) for t in (q, k, v)), *args)
    assert out.dtype == torch.bfloat16
    assert chip_smoke.bf16_mismatch(out, ref) is None


def test_half_the_blocks_dropped_fails():
    q, k, v, tables, lengths = _decode_inputs()
    ref = pa.paged_decode_attention_reference(q, k, v, tables, lengths)
    assert ref.abs().mean() < 0.1               # long rows: small outputs
    dropped = chip_smoke.decode_with_blocks_dropped(
        pa, q, k, v, tables, lengths).to(torch.bfloat16)
    why = chip_smoke.bf16_mismatch(dropped, ref)
    assert why is not None and "relative error norm" in why
    _, _, worst_row = chip_smoke.bf16_errors(dropped, ref)
    assert worst_row > 0.3
