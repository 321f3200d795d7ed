"""Rows of the folded ladder a spoiled train has reached: before pulse i
(0-based) the state fills k = 0..i, capped at nstate."""


def reached_rows(npulse, nstate):
    """Sum over the train's pulses of min(i + 1, nstate + 1)."""
    H = int(nstate) + 1
    full = max(int(npulse) - H, 0)
    head = min(int(npulse), H)
    return head * (head + 1) // 2 + full * H
