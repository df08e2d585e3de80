"""The port's copies of the backend-free modules — ``server/wire.py``,
``server/config.py``, ``devices/*`` and ``utils/{native,queue}.py`` —
against the JAX package's own tests, and the two wire codecs against each
other.

Every case of ``tests/test_wire.py``, ``test_config.py``,
``test_plutosdr.py`` and ``test_native.py`` runs here on the port: each
module's source, with its imports of ``sdrmodem_tpu.`` pointed at
``sdrmodem_tpu_torch.``, runs in a namespace of its own, and its test
functions and fixtures are collected from this module under their own
names.  ``test_native.py``'s server case starts the port's server with
``device="cpu"`` on the port's ``ServerConfig``.  The cases of ``test_native.py`` skip where the native
library is not built, as they do there.  Tolerance: none — the copies are
the same code, and the codecs must give the same bytes.
"""

import pathlib

import numpy as np
import pytest

from sdrmodem_tpu.server import wire as jwire
from sdrmodem_tpu_torch.server import wire as twire

TESTS = pathlib.Path(__file__).resolve().parent

# module -> the rewrites its source takes, beyond the package name
PORTED = {
    "test_wire": {},
    "test_config": {},
    "test_plutosdr": {},
    "test_native": {
        "SdrModemServer(config)": 'SdrModemServer(config, device="cpu")',
        "from tests.test_server import make_config, rx_request": (
            "from tests.test_server import rx_request\n"
            "    from tests.test_torch_server import make_config"),
    },
}


def _on_the_port(name: str, rewrites: dict) -> dict:
    """The namespace of ``tests/<name>.py`` run against the port."""
    path = TESTS / f"{name}.py"
    src = path.read_text().replace("sdrmodem_tpu.", "sdrmodem_tpu_torch.")
    for old, new in rewrites.items():
        assert old in src, f"{name}: {old!r} is gone; update the rewrite"
        src = src.replace(old, new)
    ns = {"__name__": f"tests.{name}_on_the_port", "__file__": str(path)}
    exec(compile(src, str(path), "exec"), ns)
    return ns


def _is_fixture(obj) -> bool:
    return type(obj).__name__ == "FixtureFunctionDefinition" or hasattr(obj, "_pytestfixturefunction")


for _name, _rewrites in PORTED.items():
    _ns = _on_the_port(_name, _rewrites)
    for _key, _obj in _ns.items():
        if _key.startswith("test_") or _is_fixture(_obj):
            assert _key not in globals(), f"{_name}: {_key} is defined twice"
            globals()[_key] = _obj
    if _name == "test_plutosdr":
        MockIioLib = _ns["MockIioLib"]  # the in-memory iio lib on the port's IioLib


def _messages(w, rng):
    """One message of every type in package ``w``'s wire, random fields."""
    def i(lo, hi):
        return int(rng.integers(lo, hi))

    doppler = w.DopplerSettings(tle=["x" * i(0, 70), "y", "z"], latitude=i(0, 1 << 31),
                                longitude=i(0, 1 << 31), altitude=i(0, 1 << 31))
    fsk = w.FskDemodulationSettings(i(-(1 << 40), 1 << 40), i(0, 1 << 31), bool(i(0, 2)))
    mod = w.FskModulationSettings(i(-(1 << 40), 1 << 40))
    files = w.FileSettings("/tmp/x%d.cf32" % i(0, 1000), i(0, 1 << 40))
    return {
        "RxRequest": w.RxRequest(
            rx_center_freq=i(0, 1 << 63), rx_sampling_freq=i(0, 1 << 32), rx_dump_file=bool(i(0, 2)),
            rx_offset=i(-(1 << 62), 1 << 62), demod_type=w.ModemType.GMSK,
            demod_baud_rate=i(1, 1 << 31), demod_decimation=i(1, 256),
            demod_destination=w.DemodDestination(i(0, 3)), doppler=doppler,
            fsk_settings=fsk, file_settings=files),
        "TxRequest": w.TxRequest(
            tx_center_freq=i(0, 1 << 63), tx_sampling_freq=i(0, 1 << 32), tx_dump_file=bool(i(0, 2)),
            tx_offset=i(-(1 << 62), 1 << 62), mod_type=w.ModemType.GMSK,
            mod_baud_rate=i(1, 1 << 31), doppler=doppler, fsk_settings=mod, file_settings=files),
        "Response": w.Response(status=w.ResponseStatus(i(0, 2)), details=i(0, 1 << 31)),
        "TxData": w.TxData(data=rng.integers(0, 256, i(0, 2048)).astype(np.uint8).tobytes()),
        "DopplerSettings": doppler,
        "FskDemodulationSettings": fsk,
        "FskModulationSettings": mod,
        "FileSettings": files,
    }


MESSAGES = list(_messages(twire, np.random.default_rng(0)))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("msg", MESSAGES)
def test_wire_messages_cross_the_packages(msg, direction):
    """Every message type encoded by one package decodes in the other and
    re-encodes to the same bytes; framed, the header parses alike."""
    src, dst = (jwire, twire) if direction == "jax_to_port" else (twire, jwire)
    rng = np.random.default_rng(MESSAGES.index(msg))
    for _ in range(20):
        m = _messages(src, rng)[msg]
        blob = m.encode()
        back = getattr(dst, msg).decode(blob)
        assert back.encode() == blob
        assert getattr(src, msg).decode(back.encode()) == m
    framed = src.frame(src.MsgType.TX_DATA, blob)
    assert dst.parse_header(framed[: dst.HEADER.size]) == src.parse_header(framed[: src.HEADER.size])
