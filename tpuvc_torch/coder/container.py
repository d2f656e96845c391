"""Binary containers for coded frames and sequences (the port's copies of
tpuvc's ``BFrameBitstream``, ``VFrameBitstream``, ``PFrameBitstream``,
``IFrameBitstream``, ``VSequenceBitstream`` and ``PSequenceBitstream``; byte
layouts identical, so each package parses the other's files).

``BFrameBitstream`` is layout-compatible with the reference's B-frame container
(LHBDC encode_B/decode_B):

  uint32 rate_id (lambda for LHBDC)
  uint16 x2 mv z-shape (h, w)
  uint32 mv y-string length
  uint32 mv z-string length
  uint16 x2 residual z-shape
  uint32 residual y-string length
  raw bytes: mv_y | mv_z | res_y | res_z   (res_z runs to EOF)

All integers little-endian.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field


@dataclass
class BFrameBitstream:
    rate_id: int
    mv_shape: tuple[int, int]
    res_shape: tuple[int, int]
    mv_y: bytes
    mv_z: bytes
    res_y: bytes
    res_z: bytes

    HEADER = "<IHHIIHHI"
    HEADER_BYTES = 24  # struct.calcsize(HEADER)

    @property
    def num_bytes(self) -> int:
        return self.HEADER_BYTES + len(self.mv_y) + len(self.mv_z) + len(
            self.res_y
        ) + len(self.res_z)

    def serialize(self) -> bytes:
        head = struct.pack(
            self.HEADER,
            self.rate_id,
            self.mv_shape[0],
            self.mv_shape[1],
            len(self.mv_y),
            len(self.mv_z),
            self.res_shape[0],
            self.res_shape[1],
            len(self.res_y),
        )
        return head + self.mv_y + self.mv_z + self.res_y + self.res_z

    @classmethod
    def deserialize(cls, blob: bytes) -> "BFrameBitstream":
        rate_id, mh, mw, n_mvy, n_mvz, rh, rw, n_resy = struct.unpack(
            cls.HEADER, blob[: cls.HEADER_BYTES]
        )
        off = cls.HEADER_BYTES
        mv_y = blob[off : off + n_mvy]
        off += n_mvy
        mv_z = blob[off : off + n_mvz]
        off += n_mvz
        res_y = blob[off : off + n_resy]
        off += n_resy
        res_z = blob[off:]
        return cls(
            rate_id=rate_id,
            mv_shape=(mh, mw),
            res_shape=(rh, rw),
            mv_y=mv_y,
            mv_z=mv_z,
            res_y=res_y,
            res_z=res_z,
        )


@dataclass
class VFrameBitstream:
    """Coded frame of the v3/v4 multi-stream codecs.

    Carries the side information the decoder cannot derive from the
    references (rate level s in thousandths, the down_ratio, temporal scales
    in hundredths, the latent z shape) and the ordered byte streams (z and
    the per-group anchor/non-anchor strings of both conditional codecs).

    Layout (little-endian):
      uint32 s_milli | uint8 down_ratio | int16 scale1_centi |
      int16 scale2_centi | uint16 zh | uint16 zw | uint16 n_streams |
      uint32 lengths[n_streams] | stream bytes...
    """

    s_milli: int
    down_ratio: int
    scale1_centi: int
    scale2_centi: int
    z_shape: tuple[int, int]
    streams: list = field(default_factory=list)

    HEADER = "<IBhhHHH"

    @property
    def num_bytes(self) -> int:
        return (
            struct.calcsize(self.HEADER)
            + 4 * len(self.streams)
            + sum(len(s) for s in self.streams)
        )

    def serialize(self) -> bytes:
        head = struct.pack(
            self.HEADER,
            self.s_milli,
            self.down_ratio,
            self.scale1_centi,
            self.scale2_centi,
            self.z_shape[0],
            self.z_shape[1],
            len(self.streams),
        )
        lens = struct.pack(f"<{len(self.streams)}I", *[len(s) for s in self.streams])
        return head + lens + b"".join(self.streams)

    @classmethod
    def deserialize(cls, blob: bytes) -> "VFrameBitstream":
        hsize = struct.calcsize(cls.HEADER)
        s_milli, dr, s1, s2, zh, zw, n = struct.unpack(cls.HEADER, blob[:hsize])
        lens = struct.unpack(f"<{n}I", blob[hsize : hsize + 4 * n])
        off = hsize + 4 * n
        streams = []
        for length in lens:
            streams.append(blob[off : off + length])
            off += length
        return cls(
            s_milli=s_milli,
            down_ratio=dr,
            scale1_centi=s1,
            scale2_centi=s2,
            z_shape=(zh, zw),
            streams=streams,
        )


@dataclass
class PFrameBitstream:
    """Coded P-frame of the DMC codec: the side information the decoder
    needs (rate level q in thousandths, the fractional down ratio in
    hundredths, the latent z shape) and the rANS streams in write order:
    MV-latent parts 0-3, MV z, frame-latent parts 0-3, frame z.

    Layout (little-endian):
      uint32 q_milli | uint16 ratio_centi | uint16 zh | uint16 zw |
      uint8 n_streams | uint32 lengths[n] | stream bytes...
    """

    q_milli: int
    ratio_centi: int
    z_shape: tuple[int, int]
    streams: list = field(default_factory=list)

    HEADER = "<IHHHB"

    @property
    def num_bytes(self) -> int:
        return (
            struct.calcsize(self.HEADER)
            + 4 * len(self.streams)
            + sum(len(s) for s in self.streams)
        )

    def serialize(self) -> bytes:
        head = struct.pack(
            self.HEADER, self.q_milli, self.ratio_centi, self.z_shape[0],
            self.z_shape[1], len(self.streams),
        )
        lens = struct.pack(f"<{len(self.streams)}I", *[len(s) for s in self.streams])
        return head + lens + b"".join(self.streams)

    @classmethod
    def deserialize(cls, blob: bytes) -> "PFrameBitstream":
        hsize = struct.calcsize(cls.HEADER)
        q_milli, rc, zh, zw, n = struct.unpack(cls.HEADER, blob[:hsize])
        lens = struct.unpack(f"<{n}I", blob[hsize : hsize + 4 * n])
        off = hsize + 4 * n
        streams = []
        for length in lens:
            streams.append(blob[off : off + length])
            off += length
        return cls(q_milli=q_milli, ratio_centi=rc, z_shape=(zh, zw), streams=streams)


@dataclass
class IFrameBitstream:
    """Coded intra frame: the ELIC stream set (10 group strings + z).

    Wraps ELICCoder.compress's output so intra frames ride in the same
    sequence files as inter frames.

    Layout (little-endian):
      uint16 zh | uint16 zw | uint8 n_streams | uint32 lengths[n] | bytes...
    The z string is always the last stream.
    """

    z_shape: tuple[int, int]
    streams: list = field(default_factory=list)

    HEADER = "<HHB"

    def serialize(self) -> bytes:
        head = struct.pack(
            self.HEADER, self.z_shape[0], self.z_shape[1], len(self.streams)
        )
        lens = struct.pack(
            f"<{len(self.streams)}I", *[len(s) for s in self.streams]
        )
        return head + lens + b"".join(self.streams)

    @classmethod
    def deserialize(cls, blob: bytes) -> "IFrameBitstream":
        hsize = struct.calcsize(cls.HEADER)
        zh, zw, n = struct.unpack(cls.HEADER, blob[:hsize])
        lens = struct.unpack(f"<{n}I", blob[hsize : hsize + 4 * n])
        off = hsize + 4 * n
        streams = []
        for L in lens:
            streams.append(blob[off : off + L])
            off += L
        return cls(z_shape=(zh, zw), streams=streams)

    @classmethod
    def from_compress(cls, out: dict) -> "IFrameBitstream":
        """Wrap an ELICCoder.compress result dict."""
        y_strings, z_string = out["strings"]
        return cls(
            z_shape=tuple(int(v) for v in out["shape"]),
            streams=list(y_strings) + [z_string],
        )

    def to_strings(self):
        """-> (y_strings, z_string) for ELICCoder.decompress."""
        return list(self.streams[:-1]), self.streams[-1]


B_FAMILY_IDS = {"lhbdc": 0, "flexrate": 1, "deform_b": 2, "flowguided_b": 3}
B_FAMILY_NAMES = {v: k for k, v in B_FAMILY_IDS.items()}


@dataclass
class VSequenceBitstream:
    """Whole hierarchically-coded sequence: ELIC I-frames + B-frames from
    one of the four B codec families, the file exchanged by
    ``tpuvc_torch.cli.encode_v`` / ``decode_v`` (and tpuvc's).

    Frames ride in CODING order with their display index, so the decoder
    replays the file order through the same DPB walk the encoder used: no
    schedule side-channel.

    ``mode`` records how device graphs were shaped during encoding:
    0 = sequential (one frame per forward), 1 = level-batched with
    ``max_batch`` frames per forward. The decoder must run the SAME batch
    shapes: a B=1 and a B=4 convolution may sum in different orders, and
    the decoder re-derives entropy parameters from reconstructed
    references, so a shape mismatch would corrupt the rANS decode.

    ``dtype`` (0=float32, 1=bfloat16 mixed precision) records the layer
    compute policy active during encoding; the decoder runs under the same
    policy, for the same reason.

    ``mesh`` (>=1) records over how many devices the encoder's level
    batches were sharded (tpuvc's ``--mesh``); the decoder must shard alike.
    In the port the mesh is one process per device (``encode_v --mesh``,
    the coders' ``set_shard``).

    Layout: b"TPV3" | uint8 family | uint16 width | uint16 height |
    uint16 gop | uint16 n_frames | uint8 mode | uint8 max_batch |
    uint8 dtype | uint8 window_gops | uint8 mesh | per frame in coding
    order: uint8 type (0=I, 1=B) | uint16 display_idx | uint32 length |
    blob. width/height are the unpadded display size. TPV2 streams (no
    mesh field) still parse, with mesh=1.
    """

    family: str
    width: int
    height: int
    gop: int
    n_frames: int
    frames: list = field(default_factory=list)  # [(type_str, idx, blob)]
    mode: int = 0
    max_batch: int = 0
    dtype: int = 0
    window_gops: int = 1
    mesh: int = 1

    MAGIC = b"TPV3"
    HEADER = "<4sBHHHHBBBBB"
    HEADER_V2 = "<4sBHHHHBBBB"

    @property
    def num_bytes(self) -> int:
        return struct.calcsize(self.HEADER) + sum(
            7 + len(b) for _, _, b in self.frames
        )

    def serialize(self) -> bytes:
        if not 1 <= max(1, self.mesh) <= 255:
            raise ValueError(
                f"mesh={self.mesh} does not fit the uint8 header field "
                "(1..255)"
            )
        out = [
            struct.pack(
                self.HEADER, self.MAGIC, B_FAMILY_IDS[self.family],
                self.width, self.height, self.gop, self.n_frames,
                self.mode, self.max_batch, self.dtype,
                max(1, self.window_gops), max(1, self.mesh),
            )
        ]
        for typ, idx, blob in self.frames:
            out.append(
                struct.pack("<BHI", 0 if typ == "I" else 1, idx, len(blob))
            )
            out.append(blob)
        return b"".join(out)

    @classmethod
    def deserialize(cls, blob: bytes) -> "VSequenceBitstream":
        if blob[:4] == b"TPV2":  # pre-mesh header, mesh=1
            hsize = struct.calcsize(cls.HEADER_V2)
            magic, fam, w, h, gop, n, mode, mb, dtype, wg = struct.unpack(
                cls.HEADER_V2, blob[:hsize]
            )
            mesh = 1
        else:
            hsize = struct.calcsize(cls.HEADER)
            magic, fam, w, h, gop, n, mode, mb, dtype, wg, mesh = (
                struct.unpack(cls.HEADER, blob[:hsize])
            )
            if magic != cls.MAGIC:
                if magic == b"TPV1":
                    raise ValueError(
                        "TPV1 stream from an older tpuvc build (no dtype "
                        "field); re-encode with this version"
                    )
                raise ValueError(f"bad sequence magic: {magic!r}")
        off = hsize
        frames = []
        for k in range(n):
            if off + 7 > len(blob):
                raise ValueError(
                    f"truncated sequence: record {k}/{n} header past EOF"
                )
            t, idx, L = struct.unpack("<BHI", blob[off : off + 7])
            off += 7
            if off + L > len(blob):
                raise ValueError(
                    f"truncated sequence: frame {idx} blob past EOF"
                )
            frames.append(
                ("I" if t == 0 else "B", idx, blob[off : off + L])
            )
            off += L
        if off != len(blob):
            raise ValueError(f"{len(blob) - off} trailing bytes")
        return cls(
            family=B_FAMILY_NAMES[fam], width=w, height=h, gop=gop,
            n_frames=n, frames=frames, mode=mode, max_batch=mb, dtype=dtype,
            window_gops=max(1, wg), mesh=max(1, mesh),
        )


@dataclass
class PSequenceBitstream:
    """Whole low-delay coded sequence: ELIC I-frames and chained DMC
    P-frames, the file exchanged by ``tpuvc_torch.cli.encode_p`` /
    ``decode_p`` (and tpuvc's).

    Layout: b"TPS1" | uint16 width | uint16 height | uint16 n_frames |
    per frame: uint8 type (0=I, 1=P) | uint32 length | blob.
    width/height are the unpadded display size; frames are coded padded
    to x64 and cropped on decode.
    """

    width: int
    height: int
    frames: list = field(default_factory=list)  # [(type_str, blob)]

    MAGIC = b"TPS1"
    HEADER = "<4sHHH"

    @property
    def num_bytes(self) -> int:
        return struct.calcsize(self.HEADER) + sum(5 + len(b) for _, b in self.frames)

    def serialize(self) -> bytes:
        out = [struct.pack(self.HEADER, self.MAGIC, self.width, self.height,
                           len(self.frames))]
        for typ, blob in self.frames:
            out.append(struct.pack("<BI", 0 if typ == "I" else 1, len(blob)))
            out.append(blob)
        return b"".join(out)

    @classmethod
    def deserialize(cls, blob: bytes) -> "PSequenceBitstream":
        hsize = struct.calcsize(cls.HEADER)
        magic, w, h, n = struct.unpack(cls.HEADER, blob[:hsize])
        if magic != cls.MAGIC:
            raise ValueError(f"bad sequence magic: {magic!r}")
        off = hsize
        frames = []
        for _ in range(n):
            t, length = struct.unpack("<BI", blob[off : off + 5])
            off += 5
            frames.append(("I" if t == 0 else "P", blob[off : off + length]))
            off += length
        return cls(width=w, height=h, frames=frames)
