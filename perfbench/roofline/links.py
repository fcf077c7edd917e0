"""The peak of the link that joins a rank's card to the others, for the
roofline of the collectives: NVLink 4 of an H100 SXM, 18 links into each
card. ``nvidia-smi nvlink -s`` on the benchmark's four-card machine reads
26.562 GB/s a link on each of the 18 (NVIDIA H100 80GB HBM3, 700 W; its
``nvidia-smi topo -m`` does not run in that sandbox), 478.1 GB/s into a
card, above the data sheet's 450 GB/s a direction: the larger of the two is
the peak, so that the least time stays a least time. A share of it is
stated with the cards' power limit beside it."""

NVLINK4_LINKS = 18
NVLINK4_LINK_BYTES_PER_S = 26.562e9
LINK_BYTES_PER_S = NVLINK4_LINKS * NVLINK4_LINK_BYTES_PER_S


def least_seconds(n_bytes: float) -> float:
    """The least time ``n_bytes`` take to enter a card over its links."""
    return n_bytes / LINK_BYTES_PER_S
