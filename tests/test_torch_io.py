"""The port's serial I/O layer against the JAX package's: the COBS codecs
(native through ctypes, and the Python codec), the packets' bytes on the
wire, the serial port over a PTY loopback, and the native library's loader
(the committed ``native/libmpcio.so`` read-only when its stamp matches the
source, else a build into the port's ``_build/``; ``native/`` never
written)."""

import hashlib
import shutil
import struct
import time
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from mpc_rs_tpu.io import cobs as jcobs
from mpc_rs_tpu.io import packets as jpk
from mpc_rs_tpu_torch.io import cobs
from mpc_rs_tpu_torch.io import packets as pk
from mpc_rs_tpu_torch.io.serial import PtyPair, SerialPort

NATIVE = Path(__file__).resolve().parents[1] / "native"


def _native_digests():
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest() for p in sorted(NATIVE.iterdir()) if p.is_file()}


@st.composite
def payloads(draw):
    """0-600 bytes, often with a run of 254 or more non-zero bytes (the
    0xFF code of COBS)."""
    data = bytearray(draw(st.binary(max_size=600)))
    if data and draw(st.booleans()):
        start = draw(st.integers(0, len(data) - 1))
        run = draw(st.integers(250, 400))
        fill = draw(st.integers(1, 255))
        data[start:start + run] = bytes([fill]) * len(data[start:start + run])
    return bytes(data)


def test_the_port_loads_the_committed_library_read_only():
    before = _native_digests()
    native = cobs.native_library()
    assert native is not None and not native.built
    assert native.path == NATIVE / "libmpcio.so"
    assert cobs.native_available() and _native_digests() == before


@settings(max_examples=300, deadline=None)
@given(payloads())
def test_cobs_codecs_match_the_jax_package(payload):
    enc = cobs.cobs_encode(payload, use_native=True)
    assert enc == cobs._py_cobs_encode(payload) == cobs.cobs_encode(payload, use_native=False)
    assert enc == jcobs.cobs_encode(payload, use_native=True) == jcobs._py_cobs_encode(payload)
    assert enc[-1] == 0 and 0 not in enc[:-1]
    if len(payload) <= 253:
        assert len(enc) == len(payload) + 2  # BUF_SIZE = SIZE + 2 (src/packet.rs:46-47)
    for use_native in (True, False):
        assert cobs.cobs_decode(enc, use_native=use_native) == payload
    assert jcobs.cobs_decode(enc) == payload


@pytest.mark.parametrize(
    "payload",
    [
        b"",
        b"\x00",
        b"\x11\x22\x00\x33",
        b"\x11\x22\x33\x44",
        b"\x00" * 10,
        bytes(range(1, 100)),
        bytes(300 % (i + 1) for i in range(254)),  # a long run crossing the 0xFF code
        bytes([1]) * 300,
    ],
)
def test_cobs_fixed_payloads_match_the_jax_package(payload):
    """``tests/test_io.py``'s payloads: both codecs of both packages agree."""
    enc = jcobs._py_cobs_encode(payload)
    assert cobs.cobs_encode(payload, use_native=True) == cobs.cobs_encode(payload, use_native=False) == enc
    assert cobs.cobs_decode(enc, use_native=True) == cobs.cobs_decode(enc, use_native=False) == payload


@pytest.mark.parametrize("frame", [b"\x02\x11\x00\x22\x00", b"\x01\x00\x01\x00", b"\x00\x05\x00"])
def test_cobs_inner_zero_raises_in_both_packages(frame):
    for decode in (lambda f: cobs.cobs_decode(f, use_native=True), lambda f: cobs.cobs_decode(f, use_native=False),
                   lambda f: jcobs.cobs_decode(f, use_native=True), jcobs._py_cobs_decode):
        with pytest.raises(ValueError):
            decode(frame)


@pytest.mark.parametrize("frame", [b"\x05\x11\x22\x00", b"\x04\x01", b"\xff" + b"\x01" * 100 + b"\x00"])
def test_cobs_truncated_frame_raises_in_both_packages(frame):
    for decode in (lambda f: cobs.cobs_decode(f, use_native=True), lambda f: cobs.cobs_decode(f, use_native=False),
                   lambda f: jcobs.cobs_decode(f, use_native=True), jcobs._py_cobs_decode):
        with pytest.raises(ValueError):
            decode(frame)


def test_use_native_true_raises_without_the_library(monkeypatch):
    monkeypatch.setattr(cobs, "native_library", lambda: None)
    with pytest.raises(RuntimeError, match="native mpcio library unavailable"):
        cobs.cobs_encode(b"\x01", use_native=True)
    with pytest.raises(RuntimeError, match="native mpcio library unavailable"):
        cobs.cobs_decode(b"\x02\x01\x00", use_native=True)
    assert cobs.cobs_encode(b"\x01") == b"\x02\x01\x00"  # None: the Python codec
    with pytest.raises(RuntimeError, match="native mpcio library unavailable"):
        SerialPort("/dev/null")


def test_a_stale_stamp_builds_the_source_into_the_ports_build_dir(monkeypatch, tmp_path):
    """A committed binary whose stamp is not the source's sha256 is not
    loaded: the source is compiled into the port's build directory."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    before = _native_digests()
    stale = tmp_path / "native"
    stale.mkdir()
    (stale / "libmpcio.so").write_bytes((NATIVE / "libmpcio.so").read_bytes())
    (stale / "libmpcio.so.src.sha256").write_text("0" * 64 + "\n")
    monkeypatch.setattr(cobs, "COMMITTED", stale / "libmpcio.so")
    monkeypatch.setattr(cobs, "BUILD_DIR", tmp_path / "_build")
    cobs.native_library.cache_clear()
    try:
        native = cobs.native_library()
        assert native is not None and native.built and native.path.parent == tmp_path / "_build"
        assert cobs.cobs_encode(b"\x11\x00\x22", use_native=True) == jcobs._py_cobs_encode(b"\x11\x00\x22")
    finally:
        cobs.native_library.cache_clear()
    assert _native_digests() == before


def test_packet_sizes_match_the_rust_layout():
    for cls, jcls, size in ((pk.State, jpk.State, 16), (pk.Control, jpk.Control, 2), (pk.Sensor, jpk.Sensor, 8),
                            (pk.Sensor2, jpk.Sensor2, 16), (pk.Sensor3, jpk.Sensor3, 17)):
        assert cls.size() == jcls.size() == size and cls.buf_size() == size + 2


def _random_values(name, rng):
    f32 = lambda: float(np.float32(rng.normal() * 10.0))  # noqa: E731
    i16 = lambda: int(rng.integers(-32768, 32768))  # noqa: E731
    return {
        "State": lambda: (f32(), f32(), f32(), f32()),
        "Control": lambda: (i16(),),
        "Sensor": lambda: (i16(), i16(), f32()),
        "Sensor2": lambda: (i16(), i16(), f32(), f32(), f32()),
        "Sensor3": lambda: (int(rng.integers(0, 256)), i16(), i16(), f32(), f32(), f32()),
    }[name]()


@pytest.mark.parametrize("name", ["State", "Control", "Sensor", "Sensor2", "Sensor3"])
def test_packet_bytes_match_the_jax_package(name):
    rng = np.random.default_rng(len(name))
    cls, jcls = getattr(pk, name), getattr(jpk, name)
    for _ in range(200):
        vals = _random_values(name, rng)
        wire = cls(*vals).as_cobs()
        assert wire == jcls(*vals).as_cobs()
        assert len(wire) == cls.buf_size()
        assert cls.from_cobs(wire) == cls(*vals)
    if name == "State":
        np.testing.assert_array_equal(pk.State(*vals).to_vector(), jpk.State(*vals).to_vector())


@pytest.mark.parametrize("name", ["State", "Control", "Sensor", "Sensor2", "Sensor3"])
def test_from_cobs_of_a_wrong_size_is_none(name):
    cls = getattr(pk, name)
    for other in ("State", "Control", "Sensor3"):
        if getattr(pk, other).size() != cls.size():
            wire = getattr(pk, other)(*_random_values(other, np.random.default_rng(3))).as_cobs()
            assert cls.from_cobs(wire) is None and getattr(jpk, name).from_cobs(wire) is None


def test_control_from_current_truncates_like_rust_as():
    currents = np.concatenate([np.linspace(-12.0, 12.0, 4801), [-0.00049, 0.00049, -0.0009999, 1.234, -9.9996,
                                                                 10.0, -10.0, 32.767, 40.0, -40.0, 1e9, -1e9]])
    for c in currents:
        got, want = pk.Control.from_current(float(c)), jpk.Control.from_current(float(c))
        assert got.u == want.u and got.as_cobs() == want.as_cobs()
    assert pk.Control.from_current(-0.00049).u == 0  # toward zero, not floor
    assert pk.Control.from_current(1.234).u == 1234 and pk.Control.from_current(-9.9996).u == -9999
    assert pk.Control.from_current(40.0).u == 32767 and pk.Control.from_current(-40.0).u == -32768


@pytest.mark.parametrize("enable", range(32))
def test_sensor3_parse_zeroes_the_disabled_channels(enable):
    vals = (enable, 100, -50, 2.5, 0.1, -0.2)
    wire = pk.Sensor3(*vals).as_cobs()
    assert wire == jpk.Sensor3(*vals).as_cobs()
    assert struct.unpack("<B2h3f", cobs.cobs_decode(wire)) == struct.unpack("<B2h3f", jcobs.cobs_decode(wire))
    en, v = pk.Sensor3.from_cobs(wire).parse()
    jen, jv = jpk.Sensor3.from_cobs(wire).parse()
    assert en == jen == enable
    np.testing.assert_array_equal(v, jv)
    full = np.array([100.0, -50.0, 2.5, np.float32(0.1), np.float32(-0.2)])
    np.testing.assert_array_equal(v, np.where([(enable >> i) & 1 for i in range(5)], full, 0.0))


def test_serial_pty_loopback():
    """uart.rs over a PTY (``tests/test_io.py:89``): the host sends Control,
    the fake MCU side answers with an 18-byte framed State; garbage before
    a frame resynchronises, a corrupt frame is dropped and counted, and a
    read with nothing sent times out."""
    pair = PtyPair()
    try:
        with SerialPort(pair.slave_path, 115200, timeout_ms=200) as port:
            port.write_packet(pk.Control(u=1234))
            frame = pair.mcu_recv()
            assert frame == jpk.Control(u=1234).as_cobs()
            c = pk.Control.from_cobs(frame[-pk.Control.buf_size():])
            assert c is not None and c.u == 1234

            st_ = pk.State(x=0.5, dx=0.0, theta=0.1, dtheta=0.0)
            pair.mcu_send(st_.as_cobs())
            got = port.read_packet(pk.State)
            np.testing.assert_allclose(got.to_vector(), [0.5, 0.0, 0.1, 0.0], atol=1e-7)

            pair.mcu_send(b"\x07\x12\x54" + st_.as_cobs())
            got2 = port.read_packet(pk.State)
            np.testing.assert_allclose(got2.to_vector(), [0.5, 0.0, 0.1, 0.0], atol=1e-7)

            assert port.n_bad_frames == 0
            pair.mcu_send(b"\x30" + b"\x11" * 16 + b"\x00")  # a code past the frame's end
            assert port.read_packet(pk.State) is None and port.n_bad_frames == 1

            for i in range(5):
                pair.mcu_send(pk.State(x=float(i), dx=0.0, theta=0.0, dtheta=0.0).as_cobs())
            assert port.read_latest_packet(pk.State).x == 4.0

            assert port.read_packet(pk.State) is None
    finally:
        pair.close()


def test_frames_sent_before_the_port_opens_arrive_intact():
    """The fake MCU streams from its start, before the host opens the port:
    a frame with bytes the canonical line discipline rewrites or acts on
    (0x0D, 0x03, 0x11, 0x13) arrives as sent, and is not echoed back to
    the MCU."""
    pair = PtyPair()
    try:
        st_ = pk.State(x=float(np.frombuffer(b"\x0d\x03\x11\x13", "<f4")[0]), dx=1.0, theta=0.0, dtheta=0.0)
        wire = st_.as_cobs()
        assert b"\x0d\x03\x11\x13" in wire
        pair.mcu_send(wire)
        time.sleep(0.05)  # the line discipline takes the bytes in asynchronously
        with SerialPort(pair.slave_path, 115200, timeout_ms=200) as port:
            got = port.read_packet(pk.State)
            assert got == st_ and port.n_bad_frames == 0
        assert pair.mcu_recv() == b""
    finally:
        pair.close()
