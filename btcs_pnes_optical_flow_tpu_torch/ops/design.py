"""Host-side IIR filter design (NumPy, float64).

A copy of ``btcs_pnes_optical_flow_tpu/ops/design.py``, so that the port
imports nothing of the JAX package.

Replaces the reference's design-time call into
``scipy.signal.butter(..., output="sos")`` (optical_PCA.py:64-71) with a
self-contained implementation: Butterworth analog prototype → band-pass
transform → bilinear transform → second-order sections with
nearest-zero pairing.  Also provides ``sosfilt_zi`` steady-state initial
conditions, needed to reproduce ``scipy.signal.sosfiltfilt``'s
forward-backward transient handling exactly (optical_PCA.py:119).

Design runs once on the host; the resulting coefficient arrays are
constants of the filter's tensor steps.
"""

from __future__ import annotations

import numpy as np


def buttap(order: int) -> tuple[np.ndarray, np.ndarray, float]:
    """Analog Butterworth low-pass prototype (zeros, poles, gain)."""
    k = np.arange(1, order + 1)
    theta = np.pi * (2 * k + order - 1) / (2 * order)
    poles = np.exp(1j * theta)
    return np.array([], dtype=complex), poles, 1.0


def lp2bp_zpk(
    z: np.ndarray, p: np.ndarray, k: float, wo: float, bw: float
) -> tuple[np.ndarray, np.ndarray, float]:
    """Low-pass prototype → band-pass (analog, zpk form)."""
    degree = len(p) - len(z)
    z_lp = z * bw / 2
    p_lp = p * bw / 2
    z_bp = np.concatenate(
        [z_lp + np.sqrt(z_lp**2 - wo**2), z_lp - np.sqrt(z_lp**2 - wo**2)]
    )
    p_bp = np.concatenate(
        [p_lp + np.sqrt(p_lp**2 - wo**2), p_lp - np.sqrt(p_lp**2 - wo**2)]
    )
    z_bp = np.append(z_bp, np.zeros(degree))
    k_bp = k * bw**degree
    return z_bp, p_bp, k_bp


def bilinear_zpk(
    z: np.ndarray, p: np.ndarray, k: float, fs: float
) -> tuple[np.ndarray, np.ndarray, float]:
    """Analog → digital via the bilinear (Tustin) transform."""
    degree = len(p) - len(z)
    fs2 = 2.0 * fs
    z_d = (fs2 + z) / (fs2 - z)
    p_d = (fs2 + p) / (fs2 - p)
    # Any zeros at analog infinity map to the Nyquist point z = -1.
    z_d = np.append(z_d, -np.ones(degree))
    k_d = k * np.real(np.prod(fs2 - z) / np.prod(fs2 - p))
    return z_d, p_d, k_d


def _nearest_real_complex_idx(fro: np.ndarray, to: complex, which: str) -> int:
    """Index into `fro` of the element nearest `to`, restricted to
    real ('real') or complex ('complex') elements."""
    order = np.argsort(np.abs(fro - to))
    if which == "real":
        mask = np.isreal(fro[order])
    else:
        mask = ~np.isreal(fro[order])
    return int(order[mask][0])


def zpk2sos(z: np.ndarray, p: np.ndarray, k: float) -> np.ndarray:
    """Convert zpk → second-order sections, 'nearest' pairing.

    Reproduces the observable behavior of SciPy's default pairing for
    digital filters: poles are consumed worst-first (closest to the unit
    circle), each paired with its conjugate (or a nearest real pole) and
    the nearest available zeros; sections are emitted worst-last with
    the overall gain folded into the first section's numerator.
    """
    z = np.atleast_1d(np.asarray(z, dtype=complex)).copy()
    p = np.atleast_1d(np.asarray(p, dtype=complex)).copy()
    if len(z) > len(p):
        raise ValueError("zpk2sos requires len(z) <= len(p)")
    # Pad to even count with zeros/poles at the origin.
    p = np.concatenate([p, np.zeros(max(len(z) - len(p), 0), complex)])
    z = np.concatenate([z, np.zeros(max(len(p) - len(z), 0), complex)])
    n_sections = (len(p) + 1) // 2
    if len(p) % 2 == 1:
        p = np.append(p, 0.0)
        z = np.append(z, 0.0)

    # Canonicalize conjugate pairs (tolerant real detection).
    def _cplxreal(vals: np.ndarray) -> np.ndarray:
        tol = 100 * np.finfo(float).eps
        real_mask = np.abs(vals.imag) <= tol * np.abs(vals)
        out = vals.copy()
        out[real_mask] = out[real_mask].real
        return out

    z = _cplxreal(z)
    p = _cplxreal(p)

    sos_list = []
    for _ in range(n_sections):
        # Worst pole: closest to the unit circle.
        p1_idx = int(np.argmin(np.abs(1.0 - np.abs(p))))
        p1 = p[p1_idx]
        p = np.delete(p, p1_idx)

        if np.isreal(p1) and np.sum(np.isreal(p)) == 0:
            # Special case: last remaining real pole, pair with nearest
            # real zero if one exists.
            z1_idx = _nearest_real_complex_idx(z, p1, "real") if np.any(np.isreal(z)) else None
            if z1_idx is not None:
                z1 = z[z1_idx]
                z = np.delete(z, z1_idx)
                sec_z = np.array([z1, 0.0])
            else:
                sec_z = np.array([0.0, 0.0])
            sec_p = np.array([p1, 0.0])
        elif len(p) + 1 == len(z) and not np.isreal(p1) and np.sum(np.isreal(p)) == 1 and np.sum(np.isreal(z)) == 1:
            # SciPy's special case three; rare — keep behaviorally close.
            p2_idx = int(np.argmin(np.abs(p - np.conj(p1))))
            p2 = p[p2_idx]
            p = np.delete(p, p2_idx)
            z1_idx = _nearest_real_complex_idx(z, p1, "complex")
            z1 = z[z1_idx]
            z = np.delete(z, z1_idx)
            z2_idx = int(np.argmin(np.abs(z - np.conj(z1))))
            z2 = z[z2_idx]
            z = np.delete(z, z2_idx)
            sec_z = np.array([z1, z2])
            sec_p = np.array([p1, p2])
        else:
            if np.isreal(p1):
                # Pair with the next-worst real pole.
                preal = p[np.isreal(p)]
                p2_idx_rel = int(np.argmin(np.abs(1.0 - np.abs(preal))))
                p2 = preal[p2_idx_rel]
                p2_idx = int(np.flatnonzero(p == p2)[0])
            else:
                p2_idx = int(np.argmin(np.abs(p - np.conj(p1))))
                p2 = p[p2_idx]
            p = np.delete(p, p2_idx)
            sec_p = np.array([p1, p2])
            # Nearest zeros (prefer complex pair for complex poles).
            if len(z) > 0:
                if not np.isreal(p1) and np.sum(~np.isreal(z)) > 0:
                    z1_idx = _nearest_real_complex_idx(z, p1, "complex")
                else:
                    z1_idx = int(np.argmin(np.abs(z - p1)))
                z1 = z[z1_idx]
                z = np.delete(z, z1_idx)
                if not np.isreal(z1):
                    z2_idx = int(np.argmin(np.abs(z - np.conj(z1))))
                    z2 = z[z2_idx]
                    z = np.delete(z, z2_idx)
                elif len(z) > 0:
                    # Pair with the nearest remaining real zero if any.
                    if np.any(np.isreal(z)):
                        z2_idx = _nearest_real_complex_idx(z, p1, "real")
                        z2 = z[z2_idx]
                        z = np.delete(z, z2_idx)
                    else:
                        z2 = 0.0
                else:
                    z2 = 0.0
                sec_z = np.array([z1, z2])
            else:
                sec_z = np.array([0.0, 0.0])

        b = np.real(np.poly(sec_z))
        a = np.real(np.poly(sec_p))
        sos_list.append(np.concatenate([b, a]))

    sos = np.array(sos_list)[::-1]  # worst section last
    sos[0, :3] *= k
    return sos


def butter_bandpass_sos(
    low_hz: float, high_hz: float, fs: float, order: int = 4
) -> np.ndarray:
    """Butterworth band-pass design in SOS form.

    Matches the reference's ``butter_bandpass_sos`` (optical_PCA.py:64-71):
    validates 0 < low < high < nyquist and returns
    ``butter(order, [low/nyq, high/nyq], btype="band", output="sos")``.
    """
    nyq = 0.5 * fs
    if not (0 < low_hz < high_hz < nyq):
        raise ValueError(
            f"Invalid band-pass range. low={low_hz}, high={high_hz}, nyquist={nyq}."
        )
    wn = np.array([low_hz / nyq, high_hz / nyq])
    # Digital design: pre-warp band edges (internal rate fs_d = 2).
    fs_d = 2.0
    warped = 2.0 * fs_d * np.tan(np.pi * wn / fs_d)
    bw = warped[1] - warped[0]
    wo = float(np.sqrt(warped[0] * warped[1]))
    z, p, k = buttap(order)
    z, p, k = lp2bp_zpk(z, p, k, wo, bw)
    z, p, k = bilinear_zpk(z, p, k, fs_d)
    return zpk2sos(z, p, k)


def lfilter_zi(b: np.ndarray, a: np.ndarray) -> np.ndarray:
    """Steady-state initial conditions for a transposed-DF2 filter.

    Solves (I - A^T) zi = B where A is the companion matrix of `a`,
    matching scipy.signal.lfilter_zi for first/second-order sections.
    """
    b = np.asarray(b, dtype=float)
    a = np.asarray(a, dtype=float)
    if a[0] != 1.0:
        b = b / a[0]
        a = a / a[0]
    n = max(len(a), len(b))
    b = np.concatenate([b, np.zeros(n - len(b))])
    a = np.concatenate([a, np.zeros(n - len(a))])
    # companion(a): first row = -a[1:]/a[0], subdiagonal ones.
    comp = np.zeros((n - 1, n - 1))
    comp[0, :] = -a[1:] / a[0]
    comp[np.arange(1, n - 1), np.arange(0, n - 2)] = 1.0
    iminus_a = np.eye(n - 1) - comp.T
    bb = b[1:] - a[1:] * b[0]
    return np.linalg.solve(iminus_a, bb)


def sosfilt_zi(sos: np.ndarray) -> np.ndarray:
    """Per-section steady-state init, scaled by cumulative DC gain.

    Matches scipy.signal.sosfilt_zi: section ``i``'s zi is scaled by the
    product of DC gains of all preceding sections.
    """
    sos = np.asarray(sos, dtype=float)
    n_sections = sos.shape[0]
    zi = np.empty((n_sections, 2))
    scale = 1.0
    for s in range(n_sections):
        b = sos[s, :3]
        a = sos[s, 3:]
        zi[s] = scale * lfilter_zi(b, a)
        scale *= b.sum() / a.sum()
    return zi


def sos_required_padlen(sos: np.ndarray) -> int:
    """Conservative sosfiltfilt pad length (optical_PCA.py:74-80)."""
    nsec = int(np.asarray(sos).shape[0])
    ntaps = 2 * nsec + 1
    return 3 * (ntaps - 1)
