"""How far the solve's work drifts over the window: GMRES iterations a
step in the window's last chunk less those in its first (bodies that
meet need more)."""


def read(t):
    c = t.chunk_iters
    return c[-1] - c[0] if len(c) > 1 else None
