"""The least bytes the rate-limit kernels must move for the window's
work, and the card's peak, frozen here so the count reads the same
whatever implements the kernels.

Counted from the benchmark's own requests, not from the program's padded
launches: each answered lane's request words once and its answer once,
and each distinct key's bucket row read once and written once.  The
sizes are those of the port's narrowest wire (chip_smoke.py's K1 bound):
a lane's slot, flags and hits in three 32-bit words; four 32-bit answer
words (status, remaining, reset and expiry as deltas), 64-bit where a
reset lies more than 2**31 - 1 ms ahead; a row of 32 bytes of hot state
(flags, remaining, stamp, expiry) and 32 of cold (limit, duration), of
which the hot half is written back.
"""

# NVIDIA H100 SXM data sheet: 3.35 TB/s of HBM3 at the full 700 W.
HBM_BYTES_PER_S = 3.35e12
LANE_IN = 3 * 4
LANE_OUT = 4 * 4
LANE_OUT_WIDE_EXTRA = 4 * 4
ROW_READ = 64
ROW_WRITE = 32


def window_bytes(lanes: int, wide_lanes: int, rows: int) -> int:
    """Bytes of `lanes` answered lanes (`wide_lanes` of them with 64-bit
    answers) over `rows` distinct bucket rows."""
    return (lanes * (LANE_IN + LANE_OUT) + wide_lanes * LANE_OUT_WIDE_EXTRA
            + rows * (ROW_READ + ROW_WRITE))


def bound_s(nbytes: int) -> float:
    """The least time the card can move `nbytes` in."""
    return nbytes / HBM_BYTES_PER_S
