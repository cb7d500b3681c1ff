"""Named host spans of the served path, on the profiler's clock.

``span(name)`` opens a host range in ``torch.profiler``'s trace (a
``RecordFunction`` of function scope, like an ``aten::`` op: no user
annotation, so the profiler gives it no twin on the device timeline).  Its
times are the trace's own clock, the one the device events use.  Without a
running profiler nothing is recorded and a span costs well under a
microsecond.

Every span of the program is named here once; the benchmark's readers
(``bench/metrics``) and the tests read the same names.
"""
from __future__ import annotations

from torch._C._profiler import _RecordFunctionFast

FIRST_TOKEN = "serve.first_token"   # ServeEngine.first_token, the whole body
STAGE = "host_store.stage"          # HostKVStore.fetch: the cat into pinned staging
SYNC = "serve.sync"                 # ServeEngine._clock: the card's synchronize
SAVE = "serve.save"                 # first_token's miss: the batch's contexts to the store
DECODE = "serve.decode"             # generate: the decode loop through its closing clock
DECODE_STEP = "model.decode_step"   # each engine call of Model.decode_step
FFN = "model.ffn"                   # apply_tf_block_decode: the feed-forward (MoE or MLP)
PREFILL_ATTN = "attn.prefill_kernel"  # attention_ctx: each call of the prefill attention kernel

NAMES = (FIRST_TOKEN, STAGE, SYNC, SAVE, DECODE, DECODE_STEP, FFN, PREFILL_ATTN)


def span(name: str) -> _RecordFunctionFast:
    """A context manager that records ``name`` as a host range while a
    profiler runs."""
    return _RecordFunctionFast(name)
