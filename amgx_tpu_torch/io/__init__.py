"""System IO (the port of amgx_tpu/io/; the reference's
src/matrix_io.cu): MatrixMarket and binary readers and writers, the
complex -> real conversions and the partitioned reads. `read_system` /
`write_system` sniff or pick the format; importing this package
registers both formats in `registry.matrix_io_readers` /
`matrix_io_writers`."""
from __future__ import annotations

from . import matrix_market, binary  # noqa: F401  (registers formats)
from ..errors import IOError_


def read_system(path: str, dtype=None, device=None):
    """Read (A, b | None, x | None) on `device` (None: the card),
    sniffing MatrixMarket against binary."""
    with open(path, "rb") as f:
        head = f.read(16)
    if head.startswith(binary._MAGIC):
        return binary.read_system(path, device=device)
    kwargs = {} if dtype is None else {"dtype": dtype}
    if head.startswith(b"%%MatrixMarket"):
        return matrix_market.read_system(path, device=device, **kwargs)
    raise IOError_(f"{path}: unrecognized system file format")


def write_system(path: str, A, b=None, x=None, fmt: str = "matrixmarket"):
    if fmt.lower() == "matrixmarket":
        return matrix_market.write_system(path, A, b, x)
    if fmt.lower() == "binary":
        return binary.write_system(path, A, b, x)
    raise IOError_(f"unknown matrix_writer format {fmt!r}")
