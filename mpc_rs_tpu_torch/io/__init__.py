"""The serial I/O layer: COBS framing, the reference's packets, the serial
port (``mpc_rs_tpu/io/``)."""

from mpc_rs_tpu_torch.io.cobs import cobs_decode, cobs_encode, native_available
from mpc_rs_tpu_torch.io.packets import Control, Sensor, Sensor2, Sensor3, State

__all__ = [
    "cobs_decode",
    "cobs_encode",
    "native_available",
    "Control",
    "Sensor",
    "Sensor2",
    "Sensor3",
    "State",
]
