"""The comparison that decides ``correct``.

Once the window has closed, a sample drawn from the seed of the
requests that completed in it (the longest always among them, then
others until ``check.served_tokens`` served tokens) is run through the
plain reference (``perfbench/reference/<family>.py``), one full forward
pass a request over its prompt and served tokens.  Served token ``j``
came from the logits at position ``prompt + j - 1``; its gap is how far
its reference logit lies below the reference's best there.  The numbers
(:func:`numbers`): ``logit_gap``, the widest gap over the sample, and
``mean_logit_gap``, the mean; the cell's workload file names the ones it
compares and their limits.

The control (``numbers(..., control=True)``) is the reference in float8 e4m3 put
in the program's place: at each of the same positions, the gap of the
token it puts first.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch


def sample(done: list, seed: int, served_tokens: int) -> list:
    """The requests to check: the longest (prompt plus output), then
    others in an order drawn from ``seed`` until ``served_tokens``
    tokens are covered."""
    if not done:
        return []
    longest = max(done, key=lambda r: (r.prompt_len + len(r.tokens),
                                       r.req.rid))
    rest = [r for r in done if r is not longest]
    order = np.random.default_rng([int(seed), 7]).permutation(len(rest))
    out, n = [longest], len(longest.tokens)
    for i in order:
        if n >= served_tokens:
            break
        out.append(rest[i])
        n += len(rest[i].tokens)
    return out


def reference(config: dict):
    return importlib.import_module(
        f"perfbench.reference.{config['reference']}")


def _sequence(r, device):
    seq = np.concatenate([np.asarray(r.req.prompt, np.int64),
                          np.asarray(r.tokens[:-1], np.int64)])
    return torch.as_tensor(seq, device=device)


def gaps(params, config: dict, reqs: list, device, quant=None):
    """Per request: (the served tokens' gaps under the f32 reference,
    and, with ``quant``, the gaps of the tokens the lower-precision
    reference puts first)."""
    ref = reference(config)
    out = []
    for r in reqs:
        seq = _sequence(r, device)
        first = r.prompt_len - 1
        want = ref.logits(params, config, seq, first)
        best = want.max(dim=-1).values
        served = torch.as_tensor(r.tokens, device=device)
        gap = best - want.gather(1, served[:, None])[:, 0]
        ctrl = None
        if quant is not None:
            low = ref.logits(params, config, seq, first, quant=quant)
            pick = low.argmax(dim=-1)
            ctrl = best - want.gather(1, pick[:, None])[:, 0]
            ctrl = ctrl.cpu().numpy()
        out.append((gap.cpu().numpy(), ctrl))
        del want
    return out


def numbers(params, config: dict, reqs: list, device,
            control: bool = False) -> tuple[dict, dict | None]:
    """The numbers the check can compare, over ``reqs``: ``logit_gap``
    (the widest gap of a served token below the reference's best) and
    ``mean_logit_gap`` (the mean over every served token); with
    ``control`` the same of the fp8 control's first tokens."""
    g = gaps(params, config, reqs, device, quant="fp8" if control else None)
    if not g:
        inf = {"logit_gap": float("inf"), "mean_logit_gap": float("inf")}
        return inf, (dict(inf) if control else None)

    def stats(arrays):
        a = np.concatenate(arrays)
        return {"logit_gap": float(a.max()), "mean_logit_gap": float(a.mean())}
    return (stats([x for x, _ in g]),
            stats([c for _, c in g]) if control else None)
