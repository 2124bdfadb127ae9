"""The proofs: the sumcheck prover (``sumcheck.py``) and the inner-product
argument (``inner_product.py``) over a Merlin transcript (``transcript.py``)."""


def ceil_log2(n: int) -> int:
    """The least k with 2^k >= n (0 for n <= 1): the number of rounds."""
    return max(int(n - 1).bit_length(), 0)
