"""Wire protocol: 6-byte framed header + proto2-encoded messages.

Clean-room implementation of the reference's protocol v0
(src/api.h:1-29, api.proto): header {uint8 version=0, uint8 type,
uint32 big-endian length} followed by a protobuf payload.  The codec is
hand-written (varint / length-delimited proto2 wire format) so existing
sdr-modem clients interoperate without generated code.

Message types: RX_REQUEST=0, SHUTDOWN=1, RESPONSE=2, PING=3, TX_DATA=4,
TX_REQUEST=5.  Max message 32 KiB (src/api_utils.c:8).

A copy of ``sdrmodem_tpu/server/wire.py`` with its imports pointing at the port.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from enum import IntEnum

PROTOCOL_VERSION = 0
MAX_MESSAGE_LENGTH = 32 * 1024
HEADER = struct.Struct(">BBI")  # version, type, length (big-endian)


class MsgType(IntEnum):
    RX_REQUEST = 0
    SHUTDOWN = 1
    RESPONSE = 2
    PING = 3
    TX_DATA = 4
    TX_REQUEST = 5


class ResponseDetails(IntEnum):
    NO_DETAILS = 0
    INVALID_REQUEST = 1
    INTERNAL_ERROR = 3
    TX_IS_BEING_USED = 4
    RX_IS_BEING_USED = 5


class ModemType(IntEnum):
    GMSK = 1


class DemodDestination(IntEnum):
    FILE = 0
    SOCKET = 1
    BOTH = 2


class ResponseStatus(IntEnum):
    SUCCESS = 0
    FAILURE = 1


class WireError(ValueError):
    pass


# ----------------------------------------------------------------------
# proto2 wire primitives

def _encode_varint(value: int) -> bytes:
    if value < 0:
        value += 1 << 64  # proto2 negative int64 -> 10-byte varint
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _decode_varint(data: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(data):
            raise WireError("truncated varint")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise WireError("varint too long")


def _signed64(value: int) -> int:
    return value - (1 << 64) if value >= 1 << 63 else value


def _tag(field_num: int, wire_type: int) -> bytes:
    return _encode_varint((field_num << 3) | wire_type)


def _field_varint(num: int, value: int) -> bytes:
    return _tag(num, 0) + _encode_varint(value)


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _tag(num, 2) + _encode_varint(len(payload)) + payload


def _iter_fields(data: bytes):
    pos = 0
    while pos < len(data):
        key, pos = _decode_varint(data, pos)
        num, wt = key >> 3, key & 7
        if wt == 0:
            value, pos = _decode_varint(data, pos)
        elif wt == 2:
            ln, pos = _decode_varint(data, pos)
            if pos + ln > len(data):
                raise WireError("truncated length-delimited field")
            value = data[pos : pos + ln]
            pos += ln
        elif wt == 5:
            if pos + 4 > len(data):
                raise WireError("truncated 32-bit field")
            value = data[pos : pos + 4]
            pos += 4
        elif wt == 1:
            if pos + 8 > len(data):
                raise WireError("truncated 64-bit field")
            value = data[pos : pos + 8]
            pos += 8
        else:
            raise WireError(f"unsupported wire type {wt}")
        yield num, wt, value


def _need_int(wt: int, v) -> int:
    """Enforce varint wire type — a mistyped field must be a WireError, not
    a TypeError deep inside a nested decode (found by decoder fuzzing)."""
    if wt != 0:
        raise WireError(f"expected varint field, got wire type {wt}")
    return v


def _need_bytes(wt: int, v) -> bytes:
    if wt != 2:
        raise WireError(f"expected length-delimited field, got wire type {wt}")
    return v


def _need_str(wt: int, v) -> str:
    try:
        return _need_bytes(wt, v).decode()
    except UnicodeDecodeError as e:
        raise WireError(f"invalid UTF-8 in string field: {e}") from e


# ----------------------------------------------------------------------
# messages (field numbers match api.proto)

@dataclass
class DopplerSettings:
    tle: list[str] = field(default_factory=list)  # 1, repeated string
    latitude: int = 0  # 2, uint32, degrees*1e6 (server divides by 10E6)
    longitude: int = 0  # 3
    altitude: int = 0  # 4

    def encode(self) -> bytes:
        out = b"".join(_field_bytes(1, t.encode()) for t in self.tle)
        out += _field_varint(2, self.latitude)
        out += _field_varint(3, self.longitude)
        out += _field_varint(4, self.altitude)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "DopplerSettings":
        msg = cls()
        for num, wt, v in _iter_fields(data):
            if num == 1:
                msg.tle.append(_need_str(wt, v))
            elif num == 2:
                msg.latitude = _need_int(wt, v)
            elif num == 3:
                msg.longitude = _need_int(wt, v)
            elif num == 4:
                msg.altitude = _need_int(wt, v)
        return msg


@dataclass
class FskDemodulationSettings:
    demod_fsk_deviation: int = 0  # 1, int64
    demod_fsk_transition_width: int = 0  # 2, uint32
    demod_fsk_use_dc_block: bool = False  # 3, bool

    def encode(self) -> bytes:
        return (
            _field_varint(1, self.demod_fsk_deviation)
            + _field_varint(2, self.demod_fsk_transition_width)
            + _field_varint(3, int(self.demod_fsk_use_dc_block))
        )

    @classmethod
    def decode(cls, data: bytes) -> "FskDemodulationSettings":
        msg = cls()
        for num, wt, v in _iter_fields(data):
            if num == 1:
                msg.demod_fsk_deviation = _signed64(_need_int(wt, v))
            elif num == 2:
                msg.demod_fsk_transition_width = _need_int(wt, v)
            elif num == 3:
                msg.demod_fsk_use_dc_block = bool(_need_int(wt, v))
        return msg


@dataclass
class FskModulationSettings:
    mod_fsk_deviation: int = 0  # 1, int64

    def encode(self) -> bytes:
        return _field_varint(1, self.mod_fsk_deviation)

    @classmethod
    def decode(cls, data: bytes) -> "FskModulationSettings":
        msg = cls()
        for num, wt, v in _iter_fields(data):
            if num == 1:
                msg.mod_fsk_deviation = _signed64(_need_int(wt, v))
        return msg


@dataclass
class FileSettings:
    filename: str = ""  # 1, string
    start_time_seconds: int = 0  # 2, uint64

    def encode(self) -> bytes:
        return _field_bytes(1, self.filename.encode()) + _field_varint(
            2, self.start_time_seconds
        )

    @classmethod
    def decode(cls, data: bytes) -> "FileSettings":
        msg = cls()
        for num, wt, v in _iter_fields(data):
            if num == 1:
                msg.filename = _need_str(wt, v)
            elif num == 2:
                msg.start_time_seconds = _need_int(wt, v)
        return msg


@dataclass
class RxRequest:
    rx_center_freq: int = 0  # 1, uint64
    rx_sampling_freq: int = 0  # 2, uint64
    rx_dump_file: bool = False  # 3, bool
    rx_offset: int = 0  # 4, int64
    demod_type: int = ModemType.GMSK  # 5, enum
    demod_baud_rate: int = 0  # 6, uint32
    demod_decimation: int = 0  # 7, uint32
    demod_destination: int = DemodDestination.SOCKET  # 8, enum
    doppler: DopplerSettings | None = None  # 9
    fsk_settings: FskDemodulationSettings | None = None  # 10
    file_settings: FileSettings | None = None  # 11

    def encode(self) -> bytes:
        out = _field_varint(1, self.rx_center_freq)
        out += _field_varint(2, self.rx_sampling_freq)
        out += _field_varint(3, int(self.rx_dump_file))
        out += _field_varint(4, self.rx_offset)
        out += _field_varint(5, self.demod_type)
        out += _field_varint(6, self.demod_baud_rate)
        out += _field_varint(7, self.demod_decimation)
        out += _field_varint(8, self.demod_destination)
        if self.doppler is not None:
            out += _field_bytes(9, self.doppler.encode())
        if self.fsk_settings is not None:
            out += _field_bytes(10, self.fsk_settings.encode())
        if self.file_settings is not None:
            out += _field_bytes(11, self.file_settings.encode())
        return out

    @classmethod
    def decode(cls, data: bytes) -> "RxRequest":
        msg = cls()
        for num, wt, v in _iter_fields(data):
            if num == 1:
                msg.rx_center_freq = _need_int(wt, v)
            elif num == 2:
                msg.rx_sampling_freq = _need_int(wt, v)
            elif num == 3:
                msg.rx_dump_file = bool(_need_int(wt, v))
            elif num == 4:
                msg.rx_offset = _signed64(_need_int(wt, v))
            elif num == 5:
                msg.demod_type = _need_int(wt, v)
            elif num == 6:
                msg.demod_baud_rate = _need_int(wt, v)
            elif num == 7:
                msg.demod_decimation = _need_int(wt, v)
            elif num == 8:
                msg.demod_destination = _need_int(wt, v)
            elif num == 9:
                msg.doppler = DopplerSettings.decode(_need_bytes(wt, v))
            elif num == 10:
                msg.fsk_settings = FskDemodulationSettings.decode(_need_bytes(wt, v))
            elif num == 11:
                msg.file_settings = FileSettings.decode(_need_bytes(wt, v))
        return msg


@dataclass
class TxRequest:
    tx_center_freq: int = 0  # 1, uint64
    tx_sampling_freq: int = 0  # 2, uint64
    tx_dump_file: bool = False  # 3, bool
    tx_offset: int = 0  # 4, int64
    mod_type: int = ModemType.GMSK  # 5, enum
    mod_baud_rate: int = 0  # 6, uint32
    doppler: DopplerSettings | None = None  # 7
    fsk_settings: FskModulationSettings | None = None  # 8
    file_settings: FileSettings | None = None  # 9

    def encode(self) -> bytes:
        out = _field_varint(1, self.tx_center_freq)
        out += _field_varint(2, self.tx_sampling_freq)
        out += _field_varint(3, int(self.tx_dump_file))
        out += _field_varint(4, self.tx_offset)
        out += _field_varint(5, self.mod_type)
        out += _field_varint(6, self.mod_baud_rate)
        if self.doppler is not None:
            out += _field_bytes(7, self.doppler.encode())
        if self.fsk_settings is not None:
            out += _field_bytes(8, self.fsk_settings.encode())
        if self.file_settings is not None:
            out += _field_bytes(9, self.file_settings.encode())
        return out

    @classmethod
    def decode(cls, data: bytes) -> "TxRequest":
        msg = cls()
        for num, wt, v in _iter_fields(data):
            if num == 1:
                msg.tx_center_freq = _need_int(wt, v)
            elif num == 2:
                msg.tx_sampling_freq = _need_int(wt, v)
            elif num == 3:
                msg.tx_dump_file = bool(_need_int(wt, v))
            elif num == 4:
                msg.tx_offset = _signed64(_need_int(wt, v))
            elif num == 5:
                msg.mod_type = _need_int(wt, v)
            elif num == 6:
                msg.mod_baud_rate = _need_int(wt, v)
            elif num == 7:
                msg.doppler = DopplerSettings.decode(_need_bytes(wt, v))
            elif num == 8:
                msg.fsk_settings = FskModulationSettings.decode(_need_bytes(wt, v))
            elif num == 9:
                msg.file_settings = FileSettings.decode(_need_bytes(wt, v))
        return msg


@dataclass
class Response:
    status: int = ResponseStatus.SUCCESS  # 1, enum
    details: int = 0  # 2, uint32

    def encode(self) -> bytes:
        return _field_varint(1, self.status) + _field_varint(2, self.details)

    @classmethod
    def decode(cls, data: bytes) -> "Response":
        msg = cls()
        for num, wt, v in _iter_fields(data):
            if num == 1:
                msg.status = _need_int(wt, v)
            elif num == 2:
                msg.details = _need_int(wt, v)
        return msg


@dataclass
class TxData:
    data: bytes = b""  # 1, bytes

    def encode(self) -> bytes:
        return _field_bytes(1, self.data)

    @classmethod
    def decode(cls, data: bytes) -> "TxData":
        msg = cls()
        for num, wt, v in _iter_fields(data):
            if num == 1:
                msg.data = bytes(_need_bytes(wt, v))
        return msg


# ----------------------------------------------------------------------
# framing

def frame(msg_type: MsgType, payload: bytes = b"") -> bytes:
    return HEADER.pack(PROTOCOL_VERSION, msg_type, len(payload)) + payload


def parse_header(data: bytes) -> tuple[int, int, int]:
    """Returns (version, type, length)."""
    return HEADER.unpack(data)


def tle_to_lines(tle: list[str]) -> list[str]:
    """char[3][80] conversion analog (api_utils.c:110-113)."""
    return [t[:79] for t in tle[:3]]
