"""``ops.detect_events(frame_spl, frame_peak_bin, p, kernel=True)``: (R,
F) float32 frame levels and int32 peak bins -> counts (R,) int32 and
rows (R, capacity, 4) float32 (K6).

Bytes: both traces read once, the counts and every row slot written
once; no floating-point work (comparisons, selects and integer adds)."""
from harness import cost as model


def cost(p, args, kwargs) -> model.Cost:
    spl = args[0]
    r, f = spl.shape
    return model.Cost(4 * (2 * r * f + r + r * p.event_capacity * 4), 0.0)
