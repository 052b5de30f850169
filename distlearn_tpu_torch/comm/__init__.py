"""Host transport of the port (copies of ``distlearn_tpu/comm``): the
packed wire codec, the framed TCP transport and its error types.  Tree,
ring, collective backends and fault injection are not ported yet."""

from distlearn_tpu_torch.comm import errors, transport, wire
from distlearn_tpu_torch.comm.errors import PeerClosed
from distlearn_tpu_torch.comm.transport import (Conn, ProtocolError, Server,
                                                connect)

__all__ = ["errors", "transport", "wire", "PeerClosed", "Conn",
           "ProtocolError", "Server", "connect"]
