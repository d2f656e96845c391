"""The check that decides ``correct``.

Every decoded frame of every sequence the window coded must equal the
encoder's reconstruction bit for bit (``decode_mismatch``, counted by the
window loop). One of the window's sequences, drawn from the seed, is then
held against the plain reference (float32, TF32 off), which makes its own
weights from the seed and reads the same frames.

With seeded weights the codecs are ill-conditioned: the MV codec's
synthesis gives flows of ~100 px RMS, so a 1% error in them moves the
warped prediction across the textures, and one latent that rounds the
other way changes every level after it. A reference that codes the
sequence on its own parts from a bfloat16 program by 0.03-0.1 RMS on
the H100, as far as from an fp8 one (PERF.md). So the reference
follows the program step by step: one I-call and one B-call of the
sampled sequence, drawn from the seed, are tapped (:mod:`harness.tap`),
and

- ``stage_rel_pct``: each stage the configuration names must have run in
  the drawn call, and is run by the reference on the program's own inputs
  to it; each stage's inputs are worked out again by the reference from
  the source frames it reads, the references that the GOP gives and the
  outputs of the stages before (the flow prior added, the residual, the
  rounding around the means...); the worst relative RMS gap of an output
  or an input, %;
- ``latent_flip_pct``: the share of the quantized latents' symbols that
  the reference's analysis and entropy parameters, on the program's
  inputs, round otherwise than the program;
- ``intra_rms``, ``inter_rms``: the reconstruction of each frame of the
  drawn calls, assembled by the reference from the inputs of the call's
  last stages (ELIC's g_s of the quantized latent; LHBDC's compensation
  and residual synthesis; FlowGuidedB's reconstructor), against the
  program's; the worst RMS gap over a frame in [0, 1] units.

The sampled sequence is coded again, by the same program object, once
the window has closed (``rerun_mismatch``: frames whose output differs
from the window's own output of that sequence, limit 0).

Each number has a limit in ``benchmark/limits/<cell>.json``, set from the
program's readings over a dozen seeds and the lower-precision control's
(PERF.md gives both); a number without a limit fails.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch


def rms(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.sqrt(torch.mean((a.float() - b.float()) ** 2)))


def reference_frames(seq, device):
    """The reference's own reading of the frames: uint8 -> [0, 1] float32."""
    def frame(i):
        return torch.from_numpy(seq.u8(i).copy()).to(device).float() / 255.0
    return frame


#: ELIC's stages, the I-frame codec of every configuration.
INTRA_STAGES = ["g_a", "h_a", "hyper_params", "group_params", "g_s"]


def program_tap(prog, seq, seed: int):
    """The tap on the program's sampled sequence."""
    from .tap import Tap

    entries, roots = prog.tap_points()
    stages = {"I": (roots["I"], INTRA_STAGES), "B": (roots["B"], prog.cfg["stages"])}
    return Tap(seq, entries, stages, seed)


@torch.no_grad()
def control_run(models_file, cfg, mix, seed, device, seq):
    """The lower-precision control in the program's place: the reference
    with fp8 operands where the configuration states bfloat16 and TF32
    where it states float32 codes the sequence on its own reconstructions,
    tapped as the program is. -> (reconstructions, the tap's kept calls)."""
    from reference import numerics, sequence

    from .tap import Tap

    models = models_file.reference(cfg, seed, device)
    intra, inter = models_file.reference_fns(models, cfg, _semantics(mix))
    stages = {"I": (models["intra"], INTRA_STAGES), "B": (models["inter"], cfg["stages"])}
    tap = Tap(seq, {}, stages, seed)
    read = reference_frames(seq, device)

    def frames(i):
        seq.log.append(i)
        return read(i)

    with tap, numerics.control():
        rec = sequence.code(frames, len(seq), mix["gop"], tap.wrap_entry("I", intra),
                            tap.wrap_entry("B", inter))
    return {i: t[0] for i, t in rec.items()}, tap.kept


def reference_roles(kind: str, *a, **k) -> dict:
    """The frame arguments of the reference's own calls (``intra(x)``,
    ``inter(x_before, x, x_after, ...)``), as the control is tapped."""
    if kind == "I":
        return {"current": a[0]}
    return {"before": a[0], "current": a[1], "after": a[2]}


def _semantics(mix: dict) -> str:
    return "stream" if mix["kind"] == "code" else "eval"


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _to(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device).float() if x.is_floating_point() else x.to(device)
    if isinstance(x, tuple):
        return tuple(_to(v, device) for v in x)
    if isinstance(x, list):
        return [_to(v, device) for v in x]
    return x


def gap_pct(got, want) -> float:
    """The relative RMS gap of ``got`` from ``want``, %, output by output
    (the worst); where ``want`` is all zeros, 0 if ``got`` is too and
    infinite if not. Outputs that differ in number or shape are infinitely
    far apart."""
    got, want = _tensors(got), _tensors(want)
    if len(got) != len(want):
        return float("inf")
    worst = 0.0
    for g, w in zip(got, want):
        g, w = g.float(), w.float().to(g.device)
        if g.shape != w.shape:
            return float("inf")
        scale = rms(w, torch.zeros_like(w))
        dist = rms(g, w)
        if scale == 0.0:
            rel = 0.0 if dist == 0.0 else float("inf")
        else:
            rel = 100.0 * dist / scale
        if rel != rel:  # NaN
            return float("inf")
        worst = max(worst, rel)
    return worst


def _anchors(i: int, gop: int) -> tuple[int, int]:
    from reference.sequence import bisection

    g0 = (i // gop) * gop
    table = {f: (a, b) for f, a, b in bisection(gop)}
    a, b = table[i - g0]
    return g0 + a, g0 + b


def entry(kind: str, call: dict, roles, seq, recons: dict, gop: int, device, note) -> dict:
    """The call's frames as the reference has them: each frame's source,
    read by the reference, and for a B-frame the reconstructions of the two
    frames that the GOP makes its references; the call's own inputs are
    held against them. -> {"current", "before", "after", "order"}."""
    frames = list(call["frames"])
    args, kwargs = call["entry"]
    given = roles(kind, *args, **kwargs)
    n = given["current"].shape[0]
    intra = [i % gop == 0 for i in frames]
    if len(frames) != n or len(set(frames)) != n or any(x != (kind == "I") for x in intra):
        note(f"{kind}:entry.frames", float("inf"))
        return {k: _to(v, device) for k, v in given.items()}
    read = reference_frames(seq, device)
    out = {"current": torch.cat([read(i) for i in frames])}
    if kind == "B":
        refs = [_anchors(i, gop) for i in frames]
        shape = out["current"].shape[1:]
        out["before"] = torch.cat([recons[a].to(device).float().reshape(1, *shape)
                                   for a, _ in refs])
        out["after"] = torch.cat([recons[b].to(device).float().reshape(1, *shape)
                                  for _, b in refs])
        out["order"] = [(i - a, 0, b - a) for i, (a, b) in zip(frames, refs)]
    for role in ("current", "before", "after"):
        if role in out:
            note(f"{kind}:entry.{role}", gap_pct(_to(given[role], device), out[role]))
    return out


@torch.no_grad()
def step_numbers(models_file, cfg, mix, seed, device, seq, recons: dict, kept: dict, roles,
                 stage_log: dict | None = None) -> dict:
    """The reference following the tapped calls ``kept`` (the program's, or
    the control's; ``roles(kind, *entry args)`` names the call's frame
    arguments) and the reconstructions ``recons`` of their frames:

    - each stage the configuration names ran in the call, and is run again
      by the reference on its recorded inputs (``stage_rel_pct``, the worst
      relative RMS gap of an output);
    - each stage's inputs are worked out again (``follow`` in the
      reference's model file): from the source frames that the reference
      reads, the references that the GOP gives, and the outputs of the
      stages before; the worst gap of an input counts in ``stage_rel_pct``;
    - ``latent_flip_pct``: the share of the quantized latents' symbols that
      the reference's analysis and entropy parameters round otherwise;
    - ``intra_rms``, ``inter_rms``: each frame's reconstruction against the
      reference's, assembled from the call's last stages' inputs.

    ``stage_log`` (if given) receives the worst gap of each stage and link."""
    from reference import elic, numerics
    from reference.elic import assemble as assemble_intra

    from .tap import _attr

    models = models_file.reference(cfg, seed, device)
    numerics.strict()
    semantics = _semantics(mix)
    roots = {"I": models["intra"], "B": models["inter"]}
    assemble = {"I": assemble_intra, "B": models_file.assemble}
    follow = {"I": elic.follow, "B": models_file.follow}
    stages = {"I": INTRA_STAGES, "B": cfg["stages"]}
    gaps: dict = {}
    out = {"intra_rms": float("inf"), "inter_rms": float("inf")}
    flips = total = 0

    def note(name, rel):
        gaps[name] = max(gaps.get(name, 0.0), rel)

    for kind in ("I", "B"):
        call = kept.get(kind)
        if call is None:
            note(f"{kind}:no call drawn", float("inf"))
            continue
        calls = {n: [(_to(a, device), _to(k, device), _to(o, device)) for a, k, o in c]
                 for n, c in call["calls"].items()}
        for name in stages[kind]:
            if not calls.get(name):
                note(f"{kind}:{name}", float("inf"))
        refs: dict = {}
        for name, cs in calls.items():
            ref_fn = _attr(roots[kind], name)
            for a, k, got in cs:
                ref = ref_fn(*a, **k)
                refs.setdefault(name, []).append(ref)
                note(f"{kind}:{name}", gap_pct(got, ref))
        given = entry(kind, call, roles, seq, recons, mix["gop"], device, note)
        frames = list(call["frames"])
        try:
            links, pairs, x_hat = follow[kind](roots[kind], given, calls, refs, cfg, semantics)
        except Exception as e:  # the calls lack what the codec's steps need
            note(f"{kind}:link.{type(e).__name__}: {e}"[:160], float("inf"))
            links, pairs, x_hat = [], [], None
        for name, got, want in links:
            note(f"{kind}:link.{name}", gap_pct(got, want))
        for mine, theirs in pairs:
            flips += int((mine != theirs).sum())
            total += mine.numel()
        x_ref = torch.clamp(assemble[kind](roots[kind], calls), 0.0, 1.0)
        key = "intra_rms" if kind == "I" else "inter_rms"
        out[key] = 0.0
        for j, i in enumerate(frames):
            got = recons[i].to(device).float().reshape(x_ref[j].shape)
            out[key] = max(out[key], rms(got, x_ref[j]))
            if x_hat is not None:
                note(f"{kind}:link.reconstruction", gap_pct(got, x_hat[j]))
    out["stage_rel_pct"] = max(gaps.values(), default=float("inf"))
    out["latent_flip_pct"] = 100.0 * flips / total if total else float("inf")
    if stage_log is not None:
        stage_log.update(gaps)
    del models
    return out


def limits(root: Path, cell: str) -> dict:
    path = root / "benchmark" / "limits" / f"{cell}.json"
    if not path.exists():
        return {}
    return json.loads(path.read_text())["limits"]


def judge(values: dict, lims: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: [value, limit]})."""
    shown = {k: [v, lims.get(k)] for k, v in values.items()}
    ok = all(lims.get(k) is not None and v <= lims[k] for k, v in values.items())
    return ok, shown
