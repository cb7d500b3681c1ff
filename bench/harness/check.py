"""The comparison that decides ``correct``.

For a served request the reference (``bench/reference``) runs once over its
prompt and the tokens the program served, and reads the logits at each
position that produced a served token; it replays whole served calls
(``traffic.Mix.check_plan``), since the MoE's capacity depends on all of a
call's tokens.  A served token's gap is how far its reference logit lies
below the reference's best at that position: 0 where the program chose the
reference's argmax, small where the two differ by a near tie, large where
the program served a wrong token.

The host store's save is read back too: the context each checked request
saved (a miss) or fetched (a hit), as the store holds it, against the keys
and values of the reference's prefill of the same prompt.  A layer's error
is the worse, of K and V, of ||saved - reference|| / ||reference|| over the
prompt's positions; a context the store lacks reads as zeros (1.0).

The numbers compared (``bench/limits/<cell>.json``) are the mean gap over
the sample's tokens, the widest where its readings lie far enough apart, and
the saved contexts' error: the worst layer's, or the first layer's where the
MoE's routing near ties move later layers' keys and values by whole experts
in sound runs as in the control (PERF.md).

The control reads, at the same positions of the same prompts and tokens, the
gap of the token that the reference in float8 puts first, and the error of
the float8 reference's own keys and values.
"""
from __future__ import annotations

import numpy as np
import torch

from bench.harness import traffic
from bench.reference import model as ref


def saved_context(blocks: tuple | None, device):
    """The store's host blocks (k_blocks, v_blocks) [n_blocks, bt, L, KV, hd]
    of one context -> (k, v) [L, tokens, KV, hd] float32 on ``device``, or
    None where the store holds no such context."""
    if blocks is None:
        return None
    return tuple(b.to(device).flatten(0, 1).movedim(1, 0).float() for b in blocks)


def context_errors(kv: list, rows: list[int], got: list) -> list[list[float]]:
    """Per request, per layer: the worse, of K and V, of the relative error
    of ``got`` ((k, v) [L, tokens, KV, hd], or None) against the reference's
    ``kv`` ([(k, v)] a layer, [G, S, KV, hd]) at row g, over its S positions."""
    errs = []
    for g, ctx in zip(rows, got):
        per_layer = []
        for layer, pair in enumerate(kv):
            worst = 0.0
            for t, want in enumerate(pair):
                want = want[g]
                have = torch.zeros_like(want)
                if ctx is not None:
                    part = ctx[t][layer, :want.shape[0]]
                    have[:part.shape[0]] = part
                worst = max(worst, float((have - want).norm() / want.norm()))
            per_layer.append(worst)
        errs.append(per_layer)
    return errs


def call_gaps(cfg: dict, weights: dict, mix: traffic.Mix, check: traffic.Check,
              served: list[np.ndarray], saved: list, device, control: bool = False) -> dict:
    """Gaps of the served tokens ``served`` (one row [new_tokens] a request
    of ``check``) and errors of the contexts ``saved`` (one a request, as
    ``saved_context`` gives it), and the control's with ``control``.  A
    miss's first token comes from the prefill's last position and the rest
    from decode steps after the prompt; a hit's first token from a decode
    step that recomputes the prompt's last position over the other S - 1
    fetched positions."""
    prompts = torch.as_tensor(check.prompts, dtype=torch.long, device=device)
    rows = [g for g, _, _ in check.requests]
    served_t = torch.as_tensor(np.stack(served), dtype=torch.long, device=device)
    S = prompts.shape[1]

    def logits(precision: str, drops: list):
        first, kv = ref.prefill(cfg, weights, prompts, precision, drops)
        if mix.hit:
            fed = torch.cat([prompts[rows, S - 1:], served_t[:, :-1]], dim=1)
            return ref.extend(cfg, weights, kv, rows, S - 1, fed, precision), kv
        rest = ref.extend(cfg, weights, kv, rows, S, served_t[:, :-1], precision)
        return torch.cat([first[rows, None], rest], dim=1), kv

    drops: list = []
    want, kv = logits("fp32", drops)
    best = want.max(-1).values
    gap = lambda took: (best - want.gather(2, took[..., None])[..., 0]).flatten()  # noqa: E731
    out = {"gaps": gap(served_t).cpu().numpy(), "ref_drops": int(sum(drops)),
           "saved_errors": context_errors(kv, rows, saved)}
    if control:
        low, kv8 = logits("fp8", [])
        out["control_gaps"] = gap(low.argmax(-1)).cpu().numpy()
        mine = [(torch.stack([k[g] for k, _ in kv8]), torch.stack([v[g] for _, v in kv8]))
                for g in rows]
        out["control_saved_errors"] = context_errors(kv, rows, mine)
    return out
