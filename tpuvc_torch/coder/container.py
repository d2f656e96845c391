"""Binary containers for coded B-frames (the port's copies of tpuvc's
``BFrameBitstream`` and ``VFrameBitstream``; byte layouts identical, so
tpuvc parses port streams).

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
