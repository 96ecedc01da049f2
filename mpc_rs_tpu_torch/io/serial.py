"""Serial transport (raw termios through the native mpcio library) and a
PTY pair that plays the MCU's side.

Port of ``mpc_rs_tpu/io/serial.py:19-115``. The reference opens
/dev/ttyUSB0 at 115200 baud with a 10 ms timeout and frames on 0x00
(examples/mpc-ukf-commu.rs:38-42, :268-277). ``SerialPort`` is the host's
side; ``PtyPair`` is the test seam: a pseudo-terminal whose master plays the
MCU, so the hardware code path runs without a robot (the sim↔HW twin of
SURVEY §4.3).
"""

from __future__ import annotations

import ctypes
import os
import pty
import tty
from typing import Optional

from mpc_rs_tpu_torch.io import cobs


class SerialPort:
    """Raw 8N1 serial port with read-until-0x00 framing."""

    def __init__(self, device: str, baud: int = 115200, timeout_ms: int = 10):
        native = cobs.native_library()
        if native is None:
            raise RuntimeError("native mpcio library unavailable (no matching native/libmpcio.so, no g++)")
        self._lib = native.lib
        self._fd = self._lib.mpcio_serial_open(device.encode(), baud)
        if self._fd < 0:
            raise OSError(f"cannot open serial device {device}")
        self.timeout_ms = timeout_ms
        self.n_bad_frames = 0  # frames that failed COBS decoding (dropped)

    def read_frame(self, max_len: int = 256) -> Optional[bytes]:
        """One COBS frame (delimiter included) or None on timeout."""
        buf = (ctypes.c_uint8 * max_len)()
        n = self._lib.mpcio_serial_read_until_zero(self._fd, buf, max_len, self.timeout_ms)
        if n <= 0:
            return None
        data = bytes(buf[:n])
        return data if data.endswith(b"\x00") else None

    def read_packet(self, packet_cls, max_len: int = 256):
        """Frame-resynchronising packet read: the reference takes the LAST
        BUF_SIZE bytes of the accumulated buffer (mppi4-commu.rs:109-117).
        A frame that fails COBS decoding (line noise, a partial read after
        an overrun) is dropped and counted in ``n_bad_frames``, not raised:
        the control loop goes on with the next good frame."""
        data = self.read_frame(max_len)
        if data is None or len(data) < packet_cls.buf_size():
            return None
        try:
            return packet_cls.from_cobs(data[-packet_cls.buf_size():])
        except ValueError:
            self.n_bad_frames += 1
            return None

    def read_latest_packet(self, packet_cls, max_len: int = 256):
        """Drain the receive queue and parse the newest complete frame, so a
        controller slower than the sensor stream acts on the freshest state
        (the reference's mpsc drain, mppi4-commu.rs:42-59)."""
        pkt = self.read_packet(packet_cls, max_len)
        if pkt is None:
            return None
        saved_timeout = self.timeout_ms
        self.timeout_ms = 0
        try:
            while True:
                nxt = self.read_packet(packet_cls, max_len)
                if nxt is None:
                    return pkt
                pkt = nxt
        finally:
            self.timeout_ms = saved_timeout

    def write(self, data: bytes) -> int:
        return self._lib.mpcio_serial_write(self._fd, data, len(data))

    def write_packet(self, pkt) -> int:
        return self.write(pkt.as_cobs())

    def close(self):
        if self._fd >= 0:
            self._lib.mpcio_serial_close(self._fd)
            self._fd = -1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class PtyPair:
    """A pty master/slave pair: open the slave path as a SerialPort, drive
    the master side as the fake MCU. The slave is raw from the start: bytes
    the MCU sends before a SerialPort opens it (and sets raw mode) would
    otherwise pass the canonical line discipline, which echoes them back to
    the MCU and rewrites some (0x0D → 0x0A), corrupting the first frames."""

    def __init__(self):
        self.master_fd, self.slave_fd = pty.openpty()
        tty.setraw(self.slave_fd)
        os.set_blocking(self.master_fd, False)
        self.slave_path = os.ttyname(self.slave_fd)

    def mcu_send(self, data: bytes):
        os.write(self.master_fd, data)

    def mcu_recv(self, n: int = 256) -> bytes:
        try:
            return os.read(self.master_fd, n)
        except BlockingIOError:
            return b""

    def close(self):
        os.close(self.master_fd)
        os.close(self.slave_fd)
