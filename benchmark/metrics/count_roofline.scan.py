"""The count passes' least time (each pass's planes, masks and counts at the
HBM rate) as a share of the card's count-kernel time in the window, in %."""

from benchmark.yardstick import count_bound_ms, is_count_kernel


def read(m):
    kernel_s = m.kernel_s(is_count_kernel)
    if not m.passes or kernel_s <= 0:
        return None
    bound_s = sum(count_bound_ms(r, w, g) for r, w, g in m.passes) / 1e3
    return bound_s / kernel_s * 100.0
