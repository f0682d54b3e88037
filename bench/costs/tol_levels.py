"""``ops.tol_levels(psd, band, ...)``: (R, n_bins) PSD and the constant
(n_bins, n_bands) band matrix -> (R, n_bands) third-octave levels."""
from harness import cost as model

_NONZERO = {}          # one host read of each band matrix


def cost(p, args, kwargs) -> model.Cost:
    psd, band = args[0], args[1]
    key = tuple(band.shape)
    if key not in _NONZERO:
        _NONZERO[key] = band.detach().cpu().numpy()
    return model.tol_levels(psd.shape[0], _NONZERO[key])
