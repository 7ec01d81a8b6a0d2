"""The work of one all-pairs RPY product of n blobs and k right-hand sides,
as kernels K1 (``pair_sweep_sym_kernel``) and K2
(``pair_sweep_ordered_kernel``) compute it: the pair fields once per
unordered pair (60 flop) and 30 flop per right-hand side and direction
(PERF.md §6 "Bounds", frozen here); the positions and forces read once and
the velocities written once."""


def flops(n: int, k: int) -> float:
    return n * n / 2 * (60 + 60 * k)


def n_bytes(n: int, k: int) -> float:
    return n * (12 + 24 * k)
