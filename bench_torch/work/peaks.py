"""The peaks a roofline share is taken against: one NVIDIA H100 SXM5 (80 GB
HBM3), at its full 700 W power limit; a run prints the card's limit beside
each share.

* Memory: 3.35 TB/s of HBM3 (NVIDIA H100 data sheet, SXM5 column).
* Integer instructions: 132 SMs x 4 warp schedulers x 32 threads = 128
  thread-instructions a clock an SM, at the 1.98 GHz boost clock (NVIDIA
  H100 Tensor Core GPU Architecture whitepaper: 132 SMs in the SXM5 part,
  four schedulers an SM, each issuing one warp instruction a clock). This
  bounds every integer instruction, whichever pipe runs it: an SM's 64
  INT32 lanes run the ALU operations, its FMA pipe runs IMAD beside them,
  so a count against the 64 INT32 lanes alone could pass 100%.
"""

HBM_BYTES_PER_S = 3.35e12
SMS = 132
THREAD_INSTRUCTIONS_PER_SM_CLOCK = 4 * 32
BOOST_HZ = 1.98e9
INT_OPS_PER_S = SMS * THREAD_INSTRUCTIONS_PER_SM_CLOCK * BOOST_HZ


def least_seconds(num_bytes: float, ops: float) -> float:
    """The least time the work could take: bytes at the memory's peak or
    operations at the instruction peak, whichever is longer."""
    return max(num_bytes / HBM_BYTES_PER_S, ops / INT_OPS_PER_S)
