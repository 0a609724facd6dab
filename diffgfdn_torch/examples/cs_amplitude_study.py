"""Statistical structure of common-slopes amplitudes over the grid.

Port of ``examples/cs_amplitude_study.py`` (the reference's
``notebooks/analyse_common_slope_amplitudes.ipynb``), two questions about
the (num_rec, num_slopes) CS amplitude matrix of the three-room dataset:

1. **Do the amplitudes cluster by room?** A 3-component Gaussian mixture
   fitted to the per-receiver amplitude vectors (dB), its components sorted
   by mean level, collects one room's receivers each, so plausible
   amplitudes for NEW positions can be sampled from the matched component.
2. **How fast do the amplitudes vary in space?** A 2-D spatial rFFT of the
   gridded amplitude map puts the energy at LOW spatial frequencies: the
   field is smooth.

Host numpy and scipy only (no device work). :func:`amplitude_statistics`
returns the numbers, :func:`draw_amplitude_maps` the per-slope maps, and
:func:`run` does both. :func:`fit_gmm` takes sklearn's mixture where it is
installed, else its own EM.

Run: python -m diffgfdn_torch.examples.cs_amplitude_study [--out /tmp/cs_amps]
"""

import argparse
from pathlib import Path
from typing import Dict

import numpy as np

from ..data.room_dataset import THREE_ROOM_DIMS, THREE_ROOM_START
from ..data.synthetic import synthesize_amplitudes


def sort_gmm_by_means(means, covs, weights):
    """Order components by descending mean level (room 1 = loudest,
    it contains the source; reference notebook, sort_gmm_by_means)."""
    order = np.flip(np.argsort(np.mean(means, axis=-1)))
    return means[order], covs[order], weights[order]


def fit_gmm(data, n_components=3, seed=0):
    """3-component full-covariance GMM (sklearn when present, else EM)."""
    try:
        from sklearn.mixture import GaussianMixture

        gmm = GaussianMixture(
            n_components=n_components, random_state=seed, n_init=3
        ).fit(data)
        return gmm.means_, gmm.covariances_, gmm.weights_
    except ImportError:
        # minimal EM fallback (diagonal-regularized full covariance)
        rng = np.random.RandomState(seed)
        n, d = data.shape
        means = data[rng.choice(n, n_components, replace=False)]
        covs = np.stack([np.cov(data.T) + 1e-6 * np.eye(d)] * n_components)
        w = np.full(n_components, 1.0 / n_components)
        for _ in range(100):
            # E-step: responsibilities
            log_p = np.stack([
                -0.5 * np.sum(
                    (data - means[k]) @ np.linalg.inv(covs[k])
                    * (data - means[k]), axis=1
                )
                - 0.5 * np.linalg.slogdet(covs[k])[1]
                + np.log(w[k])
                for k in range(n_components)
            ])
            log_p -= log_p.max(axis=0)
            r = np.exp(log_p)
            r /= r.sum(axis=0)
            # M-step
            nk = r.sum(axis=1) + 1e-9
            means = (r @ data) / nk[:, None]
            for k in range(n_components):
                diff = data - means[k]
                covs[k] = (r[k][:, None] * diff).T @ diff / nk[k]
                covs[k] += 1e-6 * np.eye(d)
            w = nk / n
        return means, covs, w


def gmm_assign(data, means, covs, weights):
    """Most-likely component per row."""
    log_p = np.stack([
        -0.5 * np.sum(
            (data - means[k]) @ np.linalg.inv(covs[k]) * (data - means[k]),
            axis=1,
        )
        - 0.5 * np.linalg.slogdet(covs[k])[1]
        + np.log(weights[k] + 1e-12)
        for k in range(len(weights))
    ])
    return np.argmax(log_p, axis=0)


def spatial_lowpass_ratio(positions, values, grid_m=0.3, cutoff_cyc_per_m=1.0):
    """Fraction of 2-D spatial-spectrum energy below the cutoff.

    Grids the scattered amplitude samples (nearest interpolation), rfft2s
    the map, and integrates |S|^2 below/above the spatial-frequency cutoff
    (reference notebook, get_2D_fft; DC is excluded from the ratio)."""
    from scipy.interpolate import griddata

    pos = np.asarray(positions)[:, :2]
    x = np.arange(pos[:, 0].min(), pos[:, 0].max() + grid_m, grid_m)
    y = np.arange(pos[:, 1].min(), pos[:, 1].max() + grid_m, grid_m)
    gx, gy = np.meshgrid(x, y, indexing="ij")
    grid = griddata(pos, values, (gx, gy), method="nearest")
    spec = np.fft.rfft2(grid - grid.mean())
    fx = np.fft.fftfreq(grid.shape[0], d=grid_m)
    fy = np.fft.rfftfreq(grid.shape[1], d=grid_m)
    f2 = fx[:, None] ** 2 + fy[None, :] ** 2
    p = np.abs(spec) ** 2
    below = float(p[f2 <= cutoff_cyc_per_m ** 2].sum())
    return below / (p.sum() + 1e-12)


def amplitude_statistics(seed=0) -> Dict:
    """The study's numbers on a dense synthetic receiver grid over the three
    rooms: the GMM's room-assignment ``accuracy``, the per-slope
    ``lowpass_ratios``, the sorted ``gmm_means_db``, the ``assign``-ment, the
    sampled per-component dB ``spread``, and the ``positions`` / ``amps`` the
    maps draw."""
    rng = np.random.RandomState(seed)
    rec, room_id = [], []
    for k in range(3):
        n = 60
        x = rng.uniform(THREE_ROOM_START[k][0] + 0.3,
                        THREE_ROOM_START[k][0] + THREE_ROOM_DIMS[k][0] - 0.3, n)
        y = rng.uniform(THREE_ROOM_START[k][1] + 0.3,
                        THREE_ROOM_START[k][1] + THREE_ROOM_DIMS[k][1] - 0.3, n)
        rec.append(np.stack([x, y, np.full(n, 1.5)], axis=-1))
        room_id.append(np.full(n, k))
    pos = np.concatenate(rec)
    room_id = np.concatenate(room_id)
    amps = synthesize_amplitudes(pos)  # (R, 3) energy amplitudes

    # GMM over per-receiver amplitude vectors -> room clusters
    data = 10.0 * np.log10(amps + 1e-9)  # the dB domain separates rooms best
    means, covs, weights = fit_gmm(data, 3, seed)
    means, covs, weights = sort_gmm_by_means(means, covs, weights)
    assign = gmm_assign(data, means, covs, weights)
    # map components -> rooms by majority vote, then score the assignment
    acc = 0
    for comp in range(3):
        members = room_id[assign == comp]
        if len(members):
            acc += int((members == np.bincount(members).argmax()).sum())
    accuracy = acc / len(room_id)

    # fresh amplitude vectors from each component (the notebook's generative
    # use: plausible amplitudes for unseen positions)
    samples = {}
    for comp in range(3):
        chol = np.linalg.cholesky(covs[comp])
        samples[comp] = means[comp] + rng.randn(10, 3) @ chol.T
    spread = float(np.mean([s.std(axis=0).mean() for s in samples.values()]))

    # spatial spectrum: smooth field -> energy at low spatial frequencies
    ratios = [spatial_lowpass_ratio(pos, amps[:, k]) for k in range(3)]
    return {
        "accuracy": accuracy,
        "lowpass_ratios": ratios,
        "gmm_means_db": means,
        "assign": assign,
        "spread": spread,
        "positions": pos,
        "amps": amps,
    }


def draw_amplitude_maps(res: Dict, out: Path) -> None:
    """``amplitude_map_slope{1,2,3}.png``: each slope's amplitude over the
    floor plan (matplotlib)."""
    from ..utils.plot import plot_position_map

    for k in range(3):
        plot_position_map(
            res["positions"], res["amps"][:, k], list(THREE_ROOM_DIMS),
            list(THREE_ROOM_START), title=f"CS amplitude, slope {k + 1}",
            cbar_label="energy amp", save_path=str(out / f"amplitude_map_slope{k + 1}.png"),
        )


def run(out_dir="/tmp/cs_amps", seed=0):
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    res = amplitude_statistics(seed)
    draw_amplitude_maps(res, out)
    print(f"GMM room-assignment accuracy: {res['accuracy']:.3f}")
    print(f"sampled per-component dB spread: {res['spread']:.2f}")
    print("spatial low-pass energy ratio per slope:", np.round(res["lowpass_ratios"], 4))
    return {
        "accuracy": res["accuracy"],
        "lowpass_ratios": res["lowpass_ratios"],
        "gmm_means_db": res["gmm_means_db"],
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description="Common-slopes amplitude statistics")
    parser.add_argument("--out", default="/tmp/cs_amps")
    args = parser.parse_args(argv)
    res = run(args.out)
    print(res)
    return res


if __name__ == "__main__":
    main()
