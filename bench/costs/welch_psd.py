"""``ops.welch_psd(x, p, scales=None)``: (R, n) or (n,) waveform, float32
or int16 with a decode scale a record -> (R, n_bins) Welch PSD."""
from harness import cost as model


def cost(p, args, kwargs) -> model.Cost:
    x = args[0]
    r, n = (1, x.shape[-1]) if x.dim() == 1 else (x.shape[0], x.shape[-1])
    return model.welch_psd(r, n, model.dtype_name(x), p.nfft, p.window_size,
                           p.hop)
