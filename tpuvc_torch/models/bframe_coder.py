"""The real-bitstream coders of the four B-frame families, as two bodies.

- :class:`HyperpriorPairCoder` (LHBDC, Flex-Rate): two mean-scale
  hyperpriors, a motion one and a residual one, written as one
  ``BFrameBitstream`` a frame. Their entropy decode needs no references, so
  a decoder submits it ahead (``decode_level_batch_async``).
- :class:`CondPairCoder` (FlowGuidedB, DeformB): two conditional ELIC
  bottlenecks, an offset one and a residual one, written as one
  ``VFrameBitstream`` a frame. Their entropy parameters depend on the
  references, so a decoder decodes chunk by chunk, stepwise
  (``decode_level_batch_steps``) where two chunks may run in turn.

A family class supplies only what is its own: its sub-coders, the context
it computes from the references, its encoder fronts, and its rate or
temporal geometry. Encoder and decoder run the same functions at the same
batch shapes under the same dtype policy, with deterministic CUDA kernels
(:func:`set_deterministic`), so the encoder's reconstruction is the
decoder's bit for bit.
"""

from __future__ import annotations

import torch

from tpuvc_torch import resolve_device
from tpuvc_torch.coder.container import BFrameBitstream, VFrameBitstream
from tpuvc_torch.coder.parallel import run_steps
from tpuvc_torch.models.cond_elic import CondELICCoder
from tpuvc_torch.ops.precision import set_deterministic
from tpuvc_torch.parallel.mesh import (
    sharded_level_decode,
    sharded_level_decode_async,
    sharded_level_encode,
)


class BFrameCoder:
    """What every B coder holds: the device (``cuda`` by default; the model
    moves there), the mesh shard and the blocking encode entry points."""

    def __init__(self, model, device=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            set_deterministic(self.device)
        self.model = model.to(self.device).eval()
        self.shard = None  # see set_shard

    def set_shard(self, shard) -> None:
        """Shard level-batched coding over a mesh: ``shard`` from
        tpuvc_torch.parallel.mesh.level_batch_sharder, or None to code on
        this device alone.

        tpuvc applies its sharder at the inputs of every device stage, its
        sub-coders' included, and XLA keeps each array logically whole. In
        the port each rank is a process of its own, so the split is coarser:
        the level-batch entry points take this rank's rows on entry, code
        them end to end (every sub-coder stage sees the smaller batch, and
        needs no hook of its own), and gather the reconstructions (and, on
        the encoder, the per-frame streams) on exit; a level the mesh size
        does not divide is coded whole on every rank. The rule depends only
        on (batch, mesh size), so a decoder over a mesh of the same size
        (``VSequenceBitstream.mesh``) runs the encoder's batch shapes and
        reproduces its floats."""
        self.shard = shard

    def _to(self, *xs):
        return [x.to(self.device) for x in xs]

    def encode(self, *args, **kw):
        """The stream of ``encode_recon`` (same arguments)."""
        return self.encode_recon(*args, **kw)[0]

    def encode_level_batch(self, *args, **kw):
        """Blocking variant of ``encode_level_batch_async`` (same
        arguments): ([frame bitstream] * B, x_hat (B, ...))."""
        resolve, x_hat = self.encode_level_batch_async(*args, **kw)
        return resolve(), x_hat


class HyperpriorPairCoder(BFrameCoder):
    """Motion hyperprior ``mv_coder``, then residual hyperprior
    ``res_coder``, each coding at the family's ``rate`` (the arguments its
    sub-coders take after their own; LHBDC's is empty).

    A family supplies ``_context(x_before, x_after)`` -> a tuple computed
    from the references alone, ``_mv_front(x_current, x_before, x_after,
    *context, *rate)`` and ``_res_front(x_current, x_pred, *rate)`` (the
    encoder's analyses and z quantization), ``_compensate(x_before, x_after,
    *context, flow_hat)`` and ``_rate_of(rate_id)`` -> the rate a stream
    header names."""

    @staticmethod
    def _bits(rate_id, mv_shape, res_shape, mv_strings, res_strings):
        return BFrameBitstream(
            rate_id=rate_id, mv_shape=tuple(mv_shape), res_shape=tuple(res_shape),
            mv_y=mv_strings[0], mv_z=mv_strings[1],
            res_y=res_strings[0], res_z=res_strings[1],
        )

    def _predict(self, x_before, x_after, mv_y_hat, rate, context=None):
        """Prediction from the references and the quantized MV latent, shared
        by encoder and decoder. ``context``: the encoder's own ``_context``
        of the same references; the decoder recomputes it with the same
        functions and shapes, which gives the same values."""
        if context is None:
            context = self._context(x_before, x_after)
        flow_hat = self.mv_coder.synthesize(mv_y_hat, *rate)
        return self._compensate(x_before, x_after, *context, flow_hat)

    def _code(self, compress, x_before, x_current, x_after, rate):
        """The encoder's device path through the sub-coders' ``compress``
        method (``compress_from`` or ``compress_batch_async``); both
        synthesise from their quantized latents, as the decoder does.
        -> (MV result, residual result, decoder-identical x_hat)."""
        x_before, x_current, x_after = self._to(x_before, x_current, x_after)
        context = self._context(x_before, x_after)
        mv = getattr(self.mv_coder, compress)(
            *self._mv_front(x_current, x_before, x_after, *context, *rate), *rate
        )
        x_pred = self._predict(x_before, x_after, mv["y_hat"], rate, context)
        res = getattr(self.res_coder, compress)(
            *self._res_front(x_current, x_pred, *rate), *rate
        )
        return mv, res, x_pred + self.res_coder.synthesize(res["y_hat"], *rate)

    @torch.no_grad()
    def _encode_recon(self, x_before, x_current, x_after, rate, rate_id):
        mv, res, x_hat = self._code("compress_from", x_before, x_current, x_after, rate)
        return self._bits(rate_id, mv["shape"], res["shape"], mv["strings"],
                          res["strings"]), x_hat

    @sharded_level_encode
    @torch.no_grad()
    def _encode_level_batch_async(self, x_before, x_current, x_after, rate, rate_id):
        """Batched real-bitstream coding of one hierarchy level, host phases
        overlapped: the device work is issued now, and ``resolve()``
        returns the per-frame BFrameBitstreams when the workers finish.
        The caller can issue the NEXT level's device work (which needs only
        x_hat) meanwhile. Returns (resolve, x_hat (B, ...)), x_hat
        decoder-identical."""
        mv, res, x_hat = self._code("compress_batch_async", x_before, x_current, x_after,
                                    rate)
        # Keep only futures and shapes: the y_hat tensors need not outlive
        # this call.
        mv_fut, res_fut = mv["strings_future"], res["strings_future"]
        mv_shape, res_shape, batch = mv["shape"], res["shape"], x_current.shape[0]

        def resolve():
            mv_strings, res_strings = mv_fut.result(), res_fut.result()
            return [self._bits(rate_id, mv_shape, res_shape, mv_strings[b], res_strings[b])
                    for b in range(batch)]

        return resolve, x_hat

    @sharded_level_decode_async
    def decode_level_batch_async(self, bitstreams):
        """Start one level's entropy decode now (host rANS + entropy
        parameters on workers; it needs no references) and return
        ``resolve(x_before, x_after)``, which runs the reference-dependent
        device tail (context, compensation, residual synthesis). A decoder
        submits every level's streams ahead, then walks the hierarchy
        calling resolve as reconstructions become available."""
        rate = self._rate_of(bitstreams[0].rate_id)
        mv_f = self.mv_coder.decompress_batch_async(
            [(b.mv_y, b.mv_z) for b in bitstreams], bitstreams[0].mv_shape, *rate
        )
        res_f = self.res_coder.decompress_batch_async(
            [(b.res_y, b.res_z) for b in bitstreams], bitstreams[0].res_shape, *rate
        )

        @torch.no_grad()
        def resolve(x_before, x_after):
            x_before, x_after = self._to(x_before, x_after)
            x_pred = self._predict(x_before, x_after, mv_f.result(), rate)
            return x_pred + self.res_coder.synthesize(res_f.result(), *rate)

        return resolve

    def decode_level_batch(self, x_before, x_after, bitstreams):
        """Blocking variant of decode_level_batch_async."""
        return self.decode_level_batch_async(bitstreams)(x_before, x_after)

    @torch.no_grad()
    def decode(self, x_before, x_after, bitstream: BFrameBitstream) -> torch.Tensor:
        """Inverse of encode (one stream set for the batch)."""
        x_before, x_after = self._to(x_before, x_after)
        batch, rate = x_before.shape[0], self._rate_of(bitstream.rate_id)
        context = self._context(x_before, x_after)
        flow_hat = self.mv_coder.decompress([bitstream.mv_y, bitstream.mv_z],
                                            bitstream.mv_shape, *rate, batch=batch)
        x_pred = self._compensate(x_before, x_after, *context, flow_hat)
        return x_pred + self.res_coder.decompress([bitstream.res_y, bitstream.res_z],
                                                  bitstream.res_shape, *rate, batch=batch)


class CondPairCoder(BFrameCoder):
    """Offset bottleneck ``offset_coder``, then residual bottleneck
    ``res_coder``, both :class:`CondELICCoder`. Each frame's stream is a
    VFrameBitstream: the offset coder's 1 + 2 * len(groups) streams, then
    the residual coder's. A residual bottleneck with a pixel stage also
    analyses the raw current frame (``x_pixel``).

    A family supplies its temporal ``geometry``, the arguments that its
    model's ``decoder_context`` takes after the references:
    ``_header(s, *geometry, z_shape, streams)`` writes it and
    ``_geometry(bitstream)`` reads it back. It may override ``_context``
    where ``fuse_offsets`` takes the references' context in another
    order."""

    def __init__(self, model, device=None):
        super().__init__(model, device)
        self.offset_coder = CondELICCoder(self.model.offset_compressor)
        self.res_coder = CondELICCoder(self.model.residual_compressor)

    @staticmethod
    def _geometry(bitstream) -> tuple:
        return ()

    def _streams_split(self):
        return 1 + 2 * len(self.model.groups)

    def _context(self, xref1, xref2, *geometry):
        """-> (conditions, the offset prior's temporal condition, what
        ``fuse_offsets`` takes after the heads)."""
        cond, offset_temp, *fuse = self.model.decoder_context(xref1, xref2, *geometry)
        return cond, offset_temp, fuse

    def _res_inputs(self, fcur, x_comp):
        return tuple(torch.cat([f, xc], dim=-1) for f, xc in zip(fcur, x_comp))

    def _recon(self, x_comp, residues):
        return self.model.reconstruct(*(xc + r for xc, r in zip(x_comp, residues)))

    def _code(self, compress, xref1, xref2, xcur, s, geometry):
        """The encoder's device path through the sub-coders' ``compress``
        method (``compress`` or ``compress_batch_async``); both bottlenecks
        synthesise from their quantized latents, so neither stream is
        decoded again. -> (offset result, residual result, x_hat)."""
        xref1, xref2, xcur = self._to(xref1, xref2, xcur)
        m = self.model
        cond, offset_temp, fuse = self._context(xref1, xref2, *geometry)
        fcur = m.features(xcur)
        inputs = tuple(torch.cat([c, f], dim=-1) for c, f in zip(cond, fcur))
        off = getattr(self.offset_coder, compress)(inputs, cond, offset_temp, s)
        x_comp = m.fuse_offsets(off["outs"], *fuse)
        x_pixel = xcur if m.residual_compressor.pixel_stage else None
        res = getattr(self.res_coder, compress)(
            self._res_inputs(fcur, x_comp), x_comp, m.residual_cond(x_comp), s,
            x_pixel=x_pixel,
        )
        assert off["z_shape"] == res["z_shape"]
        return off, res, self._recon(x_comp, res["outs"])

    @torch.no_grad()
    def _encode_recon(self, xref1, xref2, xcur, s, geometry):
        off, res, x_hat = self._code("compress", xref1, xref2, xcur, s, geometry)
        return self._header(s, *geometry, off["z_shape"], off["streams"] + res["streams"]), x_hat

    @sharded_level_encode
    @torch.no_grad()
    def _encode_level_batch_async(self, xref1, xref2, xcur, s, geometry):
        """Batched real coding of one hierarchy level with deferred host
        phases: the device work is issued now, and ``resolve()`` returns the
        per-frame VFrameBitstreams when the workers finish. Frames of one
        level share their temporal geometry, so one serves the batch.
        Returns (resolve, x_hat (B, ...))."""
        off, res, x_hat = self._code("compress_batch_async", xref1, xref2, xcur, s, geometry)
        # Keep only the resolvers and metadata: the device tensors of this
        # chunk need not outlive the call.
        off_resolve, res_resolve = off["streams_resolve"], res["streams_resolve"]
        z_shape, batch = off["z_shape"], xcur.shape[0]

        def resolve():
            off_streams, res_streams = off_resolve(), res_resolve()
            return [self._header(s, *geometry, z_shape, off_streams[b] + res_streams[b])
                    for b in range(batch)]

        return resolve, x_hat

    @torch.no_grad()
    def decode_level_batch_steps(self, xref1, xref2, bitstreams):
        """decode_level_batch stepwise: a generator that issues the chunk's
        device work on the calling thread and yields at each host round
        trip of the two bottlenecks' entropy decode (a z and two phases a
        group each), -> x_hat (B, ...). ``coder.parallel.run_steps`` drives
        one to its end, or two chunks of one level in turn, so that one's
        rANS runs while the other's device work does."""
        xref1, xref2 = self._to(xref1, xref2)
        m, b0, n = self.model, bitstreams[0], self._streams_split()
        s = b0.s_milli / 1000.0
        cond, offset_temp, fuse = self._context(xref1, xref2, *self._geometry(b0))
        heads = yield from self.offset_coder.decompress_batch_steps(
            [list(b.streams[:n]) for b in bitstreams], b0.z_shape, cond, offset_temp, s
        )
        x_comp = m.fuse_offsets(heads, *fuse)
        residues = yield from self.res_coder.decompress_batch_steps(
            [list(b.streams[n:]) for b in bitstreams], b0.z_shape, x_comp,
            m.residual_cond(x_comp), s,
        )
        return self._recon(x_comp, residues)

    @sharded_level_decode
    def decode_level_batch(self, xref1, xref2, bitstreams):
        """Inverse of encode_level_batch (the encoder's batch shapes)."""
        return run_steps(self.decode_level_batch_steps(xref1, xref2, bitstreams))[0]

    @torch.no_grad()
    def decode(self, xref1, xref2, bitstream: VFrameBitstream):
        """Inverse of encode (one stream set for the batch)."""
        xref1, xref2 = self._to(xref1, xref2)
        m, n, batch = self.model, self._streams_split(), xref1.shape[0]
        s = bitstream.s_milli / 1000.0
        cond, offset_temp, fuse = self._context(xref1, xref2, *self._geometry(bitstream))
        heads = self.offset_coder.decompress(
            bitstream.streams[:n], bitstream.z_shape, cond, offset_temp, s, batch
        )
        x_comp = m.fuse_offsets(heads, *fuse)
        residues = self.res_coder.decompress(
            bitstream.streams[n:], bitstream.z_shape, x_comp, m.residual_cond(x_comp), s,
            batch,
        )
        return self._recon(x_comp, residues)
