"""Attention gradient cases shared by the CPU tests and the card tests
(this module imports nothing, so the card tests, which run without jax,
can import it)."""

# (B, Hq, Hkv, Lq, Lkv, D, causal, window, q_offset, kv_offset)
BWD_CASES = [
    (2, 4, 4, 200, 200, 16, True, 0, 0, 0),      # Lq not a block multiple
    (2, 6, 1, 128, 128, 32, True, 0, 0, 0),      # GQA group 6
    (1, 4, 2, 130, 200, 32, True, 0, 70, 0),     # queries after a prefix
    (1, 4, 2, 100, 200, 16, True, 24, 100, 0),   # sliding window
    (1, 4, 4, 100, 300, 16, False, 0, 0, 0),     # not causal
    (1, 4, 4, 100, 100, 16, True, 0, 0, 30),     # first 30 rows see nothing
    (1, 4, 4, 100, 60, 16, False, 16, 0, 0),     # last rows see nothing
]

#: the same kinds of case at the training head dims
WIDE_BWD_CASES = [
    (1, 4, 2, 150, 150, 64, True, 0, 0, 0),      # D=64, ragged, GQA
    (1, 4, 2, 130, 200, 128, True, 32, 70, 0),   # D=128, window, prefix
]
