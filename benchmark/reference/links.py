"""The steps between a codec's stages, worked out again from what the
stages gave.

A call of a codec is recorded stage by stage: each stage's inputs and
outputs (:mod:`harness.tap`). The stages themselves are run again by the
reference on their recorded inputs; the functions here check the inputs:
each is worked out from the call's source frames and anchors (which the
reference reads and derives itself) and from the outputs of the stages
before it, by the plain steps that join the stages (pooling, padding, the
flow prior added, the residual, the rounding around the means). A
``link`` is ``(name, what the stage got, what the reference derives)``.

The quantized latents are followed twice: the link holds the program's
latent to its own rounding (exact for a sound program), and the symbol
pairs ``(program's, reference's)`` give the share of symbols that the
reference's own analysis and entropy parameters round the other way.
"""

from __future__ import annotations

import torch

from . import entropy as E
from .checkerboard import anchor_mask, keep_anchor


def only(calls: dict, name: str) -> tuple:
    """The one recorded call of stage ``name``: (args, kwargs, output)."""
    got = calls.get(name) or []
    if len(got) != 1:
        raise LinkError(f"{name}: {len(got)} calls, one expected")
    return got[0]


class LinkError(Exception):
    """The recorded calls do not have the shape the codec's steps need."""


def match_rows(calls: list, wanted: dict, n_inputs: int) -> dict:
    """Every row of every call's first ``n_inputs`` arguments is one of the
    ``wanted`` rows {key: tuple of (1, ...) tensors}, each exactly once.
    -> {key: the output rows of that row (a tuple, one per output)}."""
    left = dict(wanted)
    found = {}
    for args, _, out in calls:
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for r in range(args[0].shape[0]):
            row = tuple(a[r:r + 1] for a in args[:n_inputs])
            key = next((k for k, w in left.items()
                        if all(torch.equal(x, y) for x, y in zip(row, w))), None)
            if key is None:
                raise LinkError("a stage ran on a row that is none of the call's frames")
            del left[key]
            found[key] = tuple(o[r:r + 1] for o in outs)
    if left:
        raise LinkError(f"rows the call needs never ran: {sorted(map(str, left))[:4]}")
    return found


def symbols_pair(y_prog, means_prog, y_ref, means_ref):
    """(program's symbols, reference's) of one latent: round(y - means)."""
    return E.symbols(y_prog, means_prog), E.symbols(y_ref, means_ref)


def hyperprior(name: str, calls: dict, refs: dict, medians, x_want, links: list, flips: list):
    """A mean-scale hyperprior named ``name`` (analysis, entropy_params,
    synthesis): its input is ``x_want``; z_hat = round(z - medians) +
    medians, y_hat = round(y - means) + means. -> its synthesis output."""
    a_args, _, (y, z) = only(calls, f"{name}.analysis")
    links.append((f"{name}.analysis", a_args[0], x_want))
    p_args, _, (_, means) = only(calls, f"{name}.entropy_params")
    links.append((f"{name}.entropy_params", p_args[0], E.symbols(z, medians) + medians))
    s_args, _, out = only(calls, f"{name}.synthesis")
    links.append((f"{name}.synthesis", s_args[0], E.symbols(y, means) + means))
    y_ref = refs[f"{name}.analysis"][0][0]
    means_ref = refs[f"{name}.entropy_params"][0][1]
    flips.append(symbols_pair(y, means, y_ref, means_ref))
    return out


def checkerboard(name: str, groups, calls: dict, refs: dict, y, y_ref, hyper, semantics: str,
                 links: list, flips: list):
    """The channel groups of an ELIC-style latent (``group_params`` at
    ``name``), in the stream's two checkerboard phases (anchors on zero
    context, then the rest on the quantized anchors; each around its own
    means) or the eval's one pass (plain rounding). -> y_hat."""
    gp = calls.get(name) or []
    gp_ref = refs.get(name) or []
    phases = 2 if semantics == "stream" else 1
    if len(gp) != phases * len(groups):
        raise LinkError(f"{name}: {len(gp)} calls for {len(groups)} groups")
    ys = torch.split(y, list(groups), dim=-1)
    ys_ref = torch.split(y_ref, list(groups), dim=-1)
    anchor = anchor_mask(y.shape[-3], y.shape[-2], y.device)
    done = []
    for i, (cy, cy_ref) in enumerate(zip(ys, ys_ref)):
        mine = gp[phases * i: phases * (i + 1)]
        theirs = gp_ref[phases * i: phases * (i + 1)]
        for args, _, _ in mine:
            if int(args[0]) != i:
                raise LinkError(f"{name}: group {int(args[0])} where {i} was due")
            links.append((f"{name}.hyper", args[1], hyper))
            if i > 0:
                links.append((f"{name}.earlier_groups", args[2], torch.cat(done, dim=-1)))
        if semantics == "stream":
            (a_args, _, (_, m_a)), (n_args, _, (_, m_n)) = mine
            a_hat = (E.symbols(cy, m_a) + m_a) * anchor
            links.append((f"{name}.anchors", a_args[3], torch.zeros_like(cy)))
            links.append((f"{name}.anchors", n_args[3], a_hat))
            g_hat = torch.where(anchor > 0, a_hat, E.symbols(cy, m_n) + m_n)
            m_ref = torch.where(anchor > 0, theirs[0][1], theirs[1][1])
            flips.append(symbols_pair(cy, torch.where(anchor > 0, m_a, m_n), cy_ref, m_ref))
        else:
            g_hat = torch.round(cy)
            links.append((f"{name}.anchors", mine[0][0][3], keep_anchor(g_hat)))
            flips.append((g_hat, torch.round(cy_ref)))
        done.append(g_hat)
    return torch.cat(done, dim=-1)
