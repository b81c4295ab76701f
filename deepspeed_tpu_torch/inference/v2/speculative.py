"""Speculative-decoding policy: knob resolution and acceptance math.

Own copy of ``deepspeed_tpu/inference/v2/speculative.py``. Draft-model
speculation in the v2 engine (greedy only): a draft model proposes
``spec_k`` tokens per greedy sequence per round, and the target verifies
all ``k+1`` positions in one pass (``apply_paged_verify``, whose attention
is the paged chunk kernel K5 with C = k+1 query rows a slot). Acceptance
is exact-greedy: a proposal survives only while it equals the target's
argmax at the same position, and the first divergence is replaced by the
target's own argmax (the "bonus" token). Every committed token is a
target-argmax output, so greedy streams are token-identical to plain
decode.

This module is the host-side policy half: what "auto" resolves to for
the ``spec_draft`` / ``spec_k`` engine knobs (the autotune winner cache's
``spec_decode`` op for the pool-shape bucket, :data:`SPEC_DEFAULTS`, the
JAX cold-cache defaults, on a miss), the EMA constants for the
per-sequence acceptance floor, and ``longest_accept``. The device programs
and scheduling live in engine_v2.py; block bookkeeping in ragged.py.
"""

# what "auto" resolves to: speculation on once a draft model is passed
# (the draft_model argument is the opt-in), k = 4, floor 35 % of k
SPEC_DEFAULTS = {
    "enabled": 1,
    "spec_k": 4,
    "floor_pct": 35,     # acceptance-EMA floor, percent of spec_k
}

# Per-sequence acceptance EMA: ema <- (1-a)*ema + a*(accepted/k) after
# every verify round. A sequence latches to plain decode once its EMA sits
# below the floor after at least SPEC_MIN_ROUNDS rounds.
SPEC_EMA_ALPHA = 0.25
SPEC_MIN_ROUNDS = 3


def resolve_spec(spec_draft, spec_k, B, NB, BS, dtype, device=None):
    """Resolve engine ``spec_draft`` / ``spec_k``: "auto" consults the
    autotune winner cache for this pool-shape bucket (falling back to
    :data:`SPEC_DEFAULTS` on a miss); True/False and ints force. Returns
    (enabled, k, floor) with ``floor`` the acceptance-EMA fallback
    threshold in [0, 1]."""
    win = None
    if spec_draft == "auto" or spec_k == "auto":
        from ...ops.cuda._common import dispatch, dtype_name, spec_bucket
        win = dispatch("spec_decode", spec_bucket(B, NB, BS),
                       dtype_name(dtype), dict(SPEC_DEFAULTS), device=device)
    enabled = bool(win["enabled"]) if spec_draft == "auto" \
        else bool(spec_draft)
    k = int(win["spec_k"]) if spec_k == "auto" else int(spec_k)
    floor_pct = int(win["floor_pct"]) if win is not None \
        else SPEC_DEFAULTS["floor_pct"]
    if k < 1:
        enabled = False
    return enabled, k, floor_pct / 100.0


def longest_accept(proposed, target_next):
    """Greedy acceptance: length of the longest prefix of ``proposed`` (k
    draft tokens) matching ``target_next`` (k+1 target argmaxes, where
    ``target_next[j]`` is the target's prediction after seeing proposal j
    tokens of context). Position j is accepted iff
    ``proposed[j] == target_next[j]``; the first mismatch, whose
    replacement is ``target_next[a]``, ends the round."""
    a = 0
    for j in range(len(proposed)):
        if int(proposed[j]) != int(target_next[j]):
            break
        a += 1
    return a
