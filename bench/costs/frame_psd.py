"""``ops.frame_psd(x, p, backend=None, scales=None)``: (R, n) or (n,)
waveform, float32 or int16 with a decode scale a record -> (R, frames,
n_bins) float32 per-frame PSDs (on paper set 2, K2).

The function's own work, on every route: the records read once at the
dtype the call receives them in (int16 2 bytes a sample and a 4-byte
scale a record), each frame's PSD written once; a frame's window, real
FFT, |X|^2 and density scale (``psd_flops`` less its frame sum, which
only the Welch mean does)."""
from harness import cost as model


def cost(p, args, kwargs) -> model.Cost:
    x = args[0]
    r, n = (1, x.shape[-1]) if x.dim() == 1 else (x.shape[0], x.shape[-1])
    dtype = model.dtype_name(x)
    bins = p.nfft // 2 + 1
    frames = r * model.n_frames(n, p.window_size, p.hop)
    bytes_in = (2 if dtype == "int16" else 4) * r * n \
        + (4 * r if dtype == "int16" else 0)
    return model.Cost(bytes_in + 4 * frames * bins,
                      frames * (model.psd_flops(p.nfft, bins) - bins))
