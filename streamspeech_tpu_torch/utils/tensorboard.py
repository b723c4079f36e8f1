"""Dependency-free TensorBoard scalar event writer (the port of
``streamspeech_tpu/utils/tensorboard.py``).

fairseq mirrors training stats to tensorboard when --tensorboard-logdir is
set (`fairseq/fairseq/logging/progress_bar.py:282-299`, TensorboardProgressBarWrapper).
The port does not depend on `tensorboard` or `tensorflow`, so this module
emits the tfevents wire format directly:

- TFRecord framing: uint64-LE length, masked crc32c(length), payload,
  masked crc32c(payload) (tensorflow/core/lib/io/record_writer.cc);
- Event protobuf: wall_time (field 1, double), step (field 2, int64),
  file_version (field 3, string, first record "brain.Event:2"), summary
  (field 5) holding Summary.Value{tag (field 1), simple_value (field 2)}.

Files written here load in stock TensorBoard. A matching reader
(:func:`read_scalars`) backs the round-trip test.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, List, Tuple

# --- crc32c (Castagnoli), table-driven ------------------------------------

_CRC_TABLE: List[int] = []


def _crc_table() -> List[int]:
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78
        tab = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            tab.append(c)
        _CRC_TABLE = tab
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    tab = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = tab[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# --- minimal protobuf encoding ---------------------------------------------


def _varint(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint(num << 3 | 2) + _varint(len(payload)) + payload


def _event(wall_time: float, step: int = 0, file_version: str = "",
           summary: bytes = b"") -> bytes:
    msg = bytearray()
    msg += _varint(1 << 3 | 1) + struct.pack("<d", wall_time)
    if step:
        msg += _varint(2 << 3 | 0) + _varint(step & 0xFFFFFFFFFFFFFFFF)
    if file_version:
        msg += _field_bytes(3, file_version.encode("utf-8"))
    if summary:
        msg += _field_bytes(5, summary)
    return bytes(msg)


def _scalar_summary(tag: str, value: float) -> bytes:
    val = _field_bytes(1, tag.encode("utf-8")) \
        + _varint(2 << 3 | 5) + struct.pack("<f", value)
    return _field_bytes(1, val)


class TensorboardWriter:
    """Scalar-only SummaryWriter equivalent (one events file per logdir)."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{socket.gethostname()}.{os.getpid()}.0")
        self.path = os.path.join(logdir, fname)
        self._f = open(self.path, "ab")
        self._write(_event(time.time(), file_version="brain.Event:2"))

    def _write(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header + struct.pack("<I", _masked_crc(header))
                      + payload + struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write(_event(time.time(), step=step,
                           summary=_scalar_summary(tag, float(value))))

    def add_scalars(self, prefix: str, values: Dict[str, float],
                    step: int) -> None:
        for k, v in values.items():
            if isinstance(v, (int, float)) and v == v:
                self.add_scalar(f"{prefix}/{k}" if prefix else k, v, step)

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


# --- reader (round-trip tests / offline inspection) -------------------------


def read_scalars(path: str) -> List[Tuple[int, str, float]]:
    """Parse a tfevents file back into (step, tag, value) records, verifying
    both framing CRCs."""
    out: List[Tuple[int, str, float]] = []
    with open(path, "rb") as f:
        buf = f.read()
    pos = 0
    while pos < len(buf):
        header = buf[pos:pos + 8]
        (length,) = struct.unpack("<Q", header)
        (hcrc,) = struct.unpack("<I", buf[pos + 8:pos + 12])
        assert hcrc == _masked_crc(header), "header crc mismatch"
        payload = buf[pos + 12:pos + 12 + length]
        (pcrc,) = struct.unpack("<I",
                                buf[pos + 12 + length:pos + 16 + length])
        assert pcrc == _masked_crc(payload), "payload crc mismatch"
        pos += 16 + length
        step, summary = 0, b""
        p = 0
        while p < len(payload):
            tag = payload[p]
            field, wire = tag >> 3, tag & 7
            p += 1
            if wire == 1:
                p += 8
            elif wire == 0:
                v = 0
                shift = 0
                while True:
                    b = payload[p]
                    p += 1
                    v |= (b & 0x7F) << shift
                    shift += 7
                    if not b & 0x80:
                        break
                if field == 2:
                    step = v
            elif wire == 2:
                ln = 0
                shift = 0
                while True:
                    b = payload[p]
                    p += 1
                    ln |= (b & 0x7F) << shift
                    shift += 7
                    if not b & 0x80:
                        break
                if field == 5:
                    summary = payload[p:p + ln]
                p += ln
            elif wire == 5:
                p += 4
        sp = 0
        while sp < len(summary):
            assert summary[sp] == 0x0A
            sp += 1
            ln = 0
            shift = 0
            while True:
                b = summary[sp]
                sp += 1
                ln |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            val = summary[sp:sp + ln]
            sp += ln
            vtag, vval = "", 0.0
            vp = 0
            while vp < len(val):
                t = val[vp]
                vfield, vwire = t >> 3, t & 7
                vp += 1
                if vwire == 2:
                    vln = 0
                    shift = 0
                    while True:
                        b = val[vp]
                        vp += 1
                        vln |= (b & 0x7F) << shift
                        shift += 7
                        if not b & 0x80:
                            break
                    if vfield == 1:
                        vtag = val[vp:vp + vln].decode("utf-8")
                    vp += vln
                elif vwire == 5:
                    if vfield == 2:
                        (vval,) = struct.unpack("<f", val[vp:vp + 4])
                    vp += 4
                elif vwire == 0:
                    while val[vp] & 0x80:
                        vp += 1
                    vp += 1
                elif vwire == 1:
                    vp += 8
            out.append((step, vtag, vval))
    return out
