"""Shrinking trailing-window bucketing shared by the 2.5D hot loops.

At step t of an N/v-step right-looking factorization only the trailing
(N - t*v) x (N - t*v) submatrix is touched (paper Lemma 10), and under the
v x v tile-cyclic layout the local rows/columns belonging to that window
form a *suffix* of the local block (tile ownership is monotone in the local
tile index).  Rounding the remaining tile count up to the next power of two
gives a small set of window shapes, one step body per bucket, so the local
compute and memory traffic shrink with t.

The bucket index is a function of the step counter alone (never of the
rank's coordinates), so every rank takes the same body and joins the same
collectives in the same order.
"""

from __future__ import annotations


def window_buckets(nb: int) -> list[int]:
    """Power-of-two bucket caps covering every remaining-tile count 1..nb."""
    return [1 << k for k in range(max((nb - 1).bit_length() + 1, 1))]


def window_bucket_index(t: int, nb: int) -> int:
    """Bucket of step t: the smallest k with nb - t <= 2^k."""
    return sum(nb - t > cap for cap in window_buckets(nb))
