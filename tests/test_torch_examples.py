"""The notebook studies of ``diffgfdn_torch/examples/`` against the JAX package's.

Each JAX study is loaded from ``examples/`` as ``tests/test_examples.py``
loads it and run at that file's reduced sizes; the port's study runs on the
CPU (``device="cpu"``) on the same inputs: the JAX parameters carried
across where a study draws them (``load_jax_params``), JAX's RIR where it
draws noise. Bounds (measured values are recorded as test properties):

* loss surface: each surface within 1e-3 of its largest value (above the
  kernel bound: the z^m phase rounding, ROADMAP C7); the same argmin cell;
* colouration: band responses 1e-3 relative L2 (C7), the filterbank 1e-5,
  the band decays and colouration 0.01 dB;
* fade-in: every case 1e-4 of its peak (C5);
* low rank: explained shares 1e-6, every render 1e-4 of its peak, the mean
  EDC error 0.01 dB;
* colorless study: flatness and MSE 1e-3 relative at the start, 1e-2 after
  training (several epochs, as ROADMAP C14 and C23);
* EDR check (on JAX's RIR): both errors 1e-3 dB;
* amplitude statistics, room geometry, FLOP table: equal, floats 1e-6,
  assignments exact.

Each test also asserts the study's conclusion and its drawn files, as
``tests/test_examples.py`` does.
"""

import contextlib
import importlib.util
import io
from pathlib import Path
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_port_helpers import one_torch_thread  # noqa: F401 (a module fixture)

ROOT = Path(__file__).resolve().parents[1]


def _jax_study(name):
    spec = importlib.util.spec_from_file_location(f"{name}_jax_study",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _quiet(fn, *args, **kwargs):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kwargs)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_loop_params(delays, fs, t60, seed, f):
    """The JAX study's loop parameters: ``FeedbackLoop.init`` at PRNGKey(seed)."""
    from diffgfdn_tpu.models.feedback_loop import FeedbackLoop
    from diffgfdn_tpu.ops.absorption import decay_times_to_gain_per_sample

    gains = np.asarray(decay_times_to_gain_per_sample(t60, np.asarray(delays), fs))
    loop = FeedbackLoop(sample_rate=fs, num_groups=1, num_delay_lines_per_group=len(delays),
                        delays=delays, gains=gains)
    z = np.exp(1j * np.linspace(0.0, np.pi, f)).astype(np.complex64)
    return _numpy_tree(loop.init(jax.random.PRNGKey(seed), jnp.asarray(z)))


def _max_over_peak(got, want) -> float:
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want))) / np.max(np.abs(want)))


def test_loss_surface_matches_jax(tmp_path, record_property):
    from diffgfdn_torch.examples import loss_surface

    jmod = _jax_study("loss_surface")
    kw = dict(nfft=1024, grid=13, span=1.2)
    g_j, edc_j, edr_j, prod_j = jmod.compute_surfaces(**kw)
    params = _jax_loop_params(loss_surface.DELAYS, 16000.0, 0.25, 0, 513)
    g, edc, edr, prod = loss_surface.compute_surfaces(**kw, device="cpu", params=params)
    errs = {"edc": _max_over_peak(edc, edc_j), "edr": _max_over_peak(edr, edr_j)}
    record_property("max_over_peak", errs)
    assert np.array_equal(g, g_j) and prod == prod_j
    assert errs["edc"] < 1e-3 and errs["edr"] < 1e-3, errs
    i, j = np.unravel_index(np.argmin(edc), edc.shape)
    assert (i, j) == np.unravel_index(np.argmin(edc_j), edc_j.shape)
    # the study's conclusion on the port's own draw (tests/test_examples.py)
    g, edc, edr, prod = loss_surface.compute_surfaces(**kw, device="cpu")
    assert np.all(np.isfinite(edc)) and np.all(np.isfinite(edr))
    i, j = np.unravel_index(np.argmin(edc), edc.shape)
    assert abs(g[i] * g[j] - prod) < 0.15
    assert abs(edc[len(g) - 1 - i, len(g) - 1 - j] - edc[i, j]) < 1e-3
    out = tmp_path / "surface.png"
    _quiet(loss_surface.main, ["--out", str(out), "--grid", "5", "--nfft", "512",
                               "--device", "cpu"])
    assert out.exists()


def test_colouration_matches_jax(tmp_path, record_property):
    from diffgfdn_torch.examples import fdn_colouration as mod

    jmod = _jax_study("fdn_colouration")
    nfft, fs = 8192, 32000.0
    centres_j, h_j, w_j, t60s_j = jmod.band_responses(nfft=nfft, fs=fs)
    params = [_jax_loop_params(mod.DELAYS, fs, t60s_j[b], b, nfft // 2 + 1) for b in range(8)]
    centres, h_bands, w_bands, t60s = mod.band_responses(nfft=nfft, fs=fs, device="cpu",
                                                          params=params)
    assert np.array_equal(centres, centres_j) and np.allclose(t60s, t60s_j, rtol=1e-12)
    h_err = float(np.linalg.norm(h_bands - h_j) / np.linalg.norm(h_j))
    w_err = float(np.max(np.abs(w_bands - w_j)))
    freqs = np.fft.rfftfreq(nfft, d=1.0 / fs)
    n0 = 2 ** 11

    def readouts(m, h, w):
        top = w[-1]
        return np.array([
            m.band_decay_db(h.sum(0), top, nfft, fs),
            m.band_decay_db((w * h).sum(0), top, nfft, fs, undo_delay_samps=n0),
            m.band_decay_db(h[-1], top, nfft, fs),
            m.colouration_db(h.sum(0), freqs, centres[0], fs / 2 * 0.9),
            m.colouration_db((w * h).sum(0), freqs, centres[0], fs / 2 * 0.9),
        ])

    db_err = float(np.max(np.abs(readouts(mod, h_bands, w_bands) - readouts(jmod, h_j, w_j))))
    record_property("errors", {"h_rel_l2": h_err, "w_max_abs": w_err, "db": db_err})
    assert h_err < 1e-3 and w_err < 1e-5 and db_err < 0.01, (h_err, w_err, db_err)
    # the conclusion on the port's own draw (tests/test_examples.py)
    centres, h_bands, w_bands, _ = mod.band_responses(nfft=nfft, fs=fs, device="cpu")
    d_plain, d_filt, d_ref, _, _ = readouts(mod, h_bands, w_bands)
    assert abs(d_filt - d_ref) < 2.0, (d_filt, d_ref)
    assert d_plain > d_filt + 3.0, (d_plain, d_filt)
    sel = (freqs >= centres[0]) & (freqs <= fs / 2 * 0.9)
    assert np.allclose(np.abs(w_bands.sum(0))[sel], 1.0, atol=0.1)
    assert np.isfinite(mod.colouration_db(h_bands.sum(0), freqs, centres[0], fs / 2 * 0.9))
    out = tmp_path / "colouration.png"
    _quiet(mod.main, ["--out", str(out), "--nfft", "4096", "--device", "cpu"])
    assert out.exists()


def test_fadein_matches_jax(tmp_path, record_property):
    from diffgfdn_torch.examples import fadein_study as mod

    jmod = _jax_study("fadein_study")
    fs, t60s = 8000.0, (0.25, 0.9)
    t_j, rirs_j, analytic_j, t0_j, u_j = jmod.synthesize_cases(fs=fs, t60s=t60s, dur_s=0.4)
    t, rirs, analytic, t0, u = mod.synthesize_cases(fs=fs, t60s=t60s, dur_s=0.4, device="cpu")
    assert np.array_equal(t, t_j) and t0 == t0_j and np.allclose(analytic, analytic_j)
    assert list(rirs) == list(rirs_j)
    errs = {name: _max_over_peak(rirs[name], rirs_j[name]) for name in rirs}
    errs["u"] = _max_over_peak(u, u_j)
    record_property("max_over_peak", errs)
    assert max(errs.values()) < 1e-4, errs
    # the conclusion (tests/test_examples.py)
    d = 3.0 * np.log(10) / np.asarray(t60s)
    w = 0.2 / np.sqrt(abs(d[1] - d[0]))
    pred = w * (np.exp(-d[0] * t) - np.exp(-d[1] * t)) * u
    got = rirs["uncoupled, +/- taps"]
    assert np.max(np.abs(got - pred)) < 1e-3 * np.max(np.abs(got))
    pred_ss = 0.35 * (np.exp(-d[0] * t) + np.exp(-d[1] * t)) * u
    got_ss = rirs["uncoupled, same-sign taps"]
    assert np.max(np.abs(got_ss - pred_ss)) < 1e-3 * np.max(np.abs(got_ss))
    win = int(0.01 * fs)
    pk_pm = t[np.argmax(mod.envelope_db(got, win))] - t0
    pk_ss = t[np.argmax(mod.envelope_db(got_ss, win))] - t0
    assert pk_pm > pk_ss + 0.01, (pk_pm, pk_ss)
    assert 0 < np.argmax(analytic) < len(t) - 1
    out = tmp_path / "fadein.png"
    mod.draw_fadein(t, rirs, analytic, t0, win, str(out))
    assert out.exists()


def test_low_rank_study_matches_jax(tmp_path, monkeypatch, record_property):
    import diffgfdn_tpu.kernels.tdgfdn as jax_tdgfdn
    from diffgfdn_torch.examples import low_rank_study as mod

    renders = {"jax": [], "port": []}

    def recording(fn, key):
        def wrapped(*args):
            out = fn(*args)
            renders[key].append(np.asarray(out))
            return out
        return wrapped

    monkeypatch.setattr(jax_tdgfdn, "synthesize_rirs_time_domain",
                        recording(jax_tdgfdn.synthesize_rirs_time_domain, "jax"))
    monkeypatch.setattr(mod, "synthesize_rirs_time_domain",
                        recording(mod.synthesize_rirs_time_domain, "port"))
    res_j = _quiet(_jax_study("low_rank_study").run, str(tmp_path / "jax"))
    res = _quiet(mod.run, str(tmp_path / "port"), device="cpu")
    assert len(renders["jax"]) == len(renders["port"]) == 4  # the probes, then 3 sources
    errs = {
        "explained": float(np.max(np.abs(res["explained"] - res_j["explained"]))),
        "render": max(_max_over_peak(p, j) for p, j in zip(renders["port"], renders["jax"])),
        "mean_edc_db": abs(res["mean_edc_err_db"] - res_j["mean_edc_err_db"]),
    }
    record_property("errors", errs)
    assert errs["explained"] < 1e-6 and errs["render"] < 1e-4 and errs["mean_edc_db"] < 0.01
    assert (res["num_src"], res["num_rec"]) == (res_j["num_src"], res_j["num_rec"])
    # the conclusion (tests/test_examples.py)
    assert np.all(res["explained"] > 0.95)
    assert res["mean_edc_err_db"] < 4.0
    assert (tmp_path / "port" / "low_rank_edc_error_map.png").exists()


def test_colorless_study_matches_jax(tmp_path, record_property):
    from diffgfdn_torch.examples import colorless_output_study as mod
    from diffgfdn_tpu.models.colorless import ColorlessFDN

    epochs, fs = 5, 8000.0
    res_j = _quiet(_jax_study("colorless_output_study").run, str(tmp_path / "jax"),
                   epochs=epochs)
    z = np.exp(1j * np.linspace(0.0, np.pi, mod.NUM_EVAL, endpoint=False)).astype(np.complex64)
    params = [_numpy_tree(ColorlessFDN(sample_rate=fs, delays=d).init(
        jax.random.PRNGKey(g), jnp.asarray(z[:16]))) for g, d in enumerate(mod.GROUP_DELAYS)]
    res = mod.train_groups(str(tmp_path / "port"), fs, epochs, device="cpu", params=params)
    errs = {k: max(abs(r[k] - rj[k]) / abs(rj[k]) for r, rj in zip(res, res_j))
            for k in ("flat0", "mse0", "flat1", "mse1")}
    record_property("max_rel", errs)
    assert errs["flat0"] < 1e-3 and errs["mse0"] < 1e-3, errs
    assert errs["flat1"] < 1e-2 and errs["mse1"] < 1e-2, errs
    # the conclusion (tests/test_examples.py) in both packages on this draw
    for results in (res, res_j):
        assert len(results) == 3
        for r in results:
            assert r["flat1"] > r["flat0"]
            assert r["mse1"] < 0.5 * r["mse0"]
    mod.draw_responses(res, tmp_path / "port", fs)
    assert (tmp_path / "port" / "colorless_responses.png").exists()
    assert (tmp_path / "port" / "group2").is_dir()


def test_check_edr_loss_matches_jax(tmp_path, record_property):
    from diffgfdn_torch.examples import check_edr_loss as mod

    jmod = _jax_study("check_edr_loss")
    res_j = _quiet(jmod.run, str(tmp_path / "jax"))
    rir_j, _ = jmod.make_rir()
    res = mod.edr_errors(device="cpu", rir=rir_j)
    errs = {k: abs(res[k] - res_j[k]) for k in ("err_irfft_db", "err_shortcut_db")}
    record_property("db", errs)
    assert max(errs.values()) < 1e-3, errs
    # the conclusion on the port's own RIR (tests/test_examples.py)
    res = _quiet(mod.run, str(tmp_path / "edr"), device="cpu")
    assert res["err_irfft_db"] < 0.05
    assert res["err_shortcut_db"] > 20.0 * res["err_irfft_db"]
    assert res["err_shortcut_db"] > 5.0
    assert (tmp_path / "edr" / "edr_comparison.png").exists()


@pytest.mark.parametrize("branch", ["sklearn", "em"])
def test_cs_amplitude_study_matches_jax(tmp_path, monkeypatch, branch, record_property):
    """Each branch of ``fit_gmm`` against JAX's same branch (the card's image
    has no sklearn and takes the EM)."""
    from diffgfdn_torch.examples import cs_amplitude_study as mod

    if branch == "em":
        monkeypatch.setitem(sys.modules, "sklearn.mixture", None)
    else:
        pytest.importorskip("sklearn.mixture")
    jmod = _jax_study("cs_amplitude_study")
    res_j = _quiet(jmod.run, str(tmp_path / "jax"))
    res = _quiet(mod.run, str(tmp_path / "port"))
    stats = mod.amplitude_statistics()
    data = 10.0 * np.log10(stats["amps"] + 1e-9)
    assign_j = jmod.gmm_assign(data, *jmod.sort_gmm_by_means(*jmod.fit_gmm(data, 3, 0)))
    errs = {"means": float(np.max(np.abs(res["gmm_means_db"] - res_j["gmm_means_db"]))),
            "lowpass": float(np.max(np.abs(np.subtract(res["lowpass_ratios"],
                                                       res_j["lowpass_ratios"]))))}
    record_property("max_abs", errs)
    assert res["accuracy"] == res_j["accuracy"]
    assert errs["means"] < 1e-6 and errs["lowpass"] < 1e-6, errs
    assert np.array_equal(stats["assign"], assign_j)
    record_property("accuracy", res["accuracy"])
    # the conclusion (tests/test_examples.py): the room clustering holds on
    # sklearn's mixture; JAX's EM fallback stops in a poorer optimum on this
    # data in both packages (113 of 180 receivers, ROADMAP C25)
    if branch == "sklearn":
        assert res["accuracy"] > 0.85
    else:
        assert res["accuracy"] == pytest.approx(113 / 180)
    assert all(ratio > 0.9 for ratio in res["lowpass_ratios"])
    assert (tmp_path / "port" / "amplitude_map_slope1.png").exists()


def test_room_geometry_study_matches_jax(tmp_path, record_property):
    from diffgfdn_torch.examples import room_geometry_study as mod

    res_j = _quiet(_jax_study("room_geometry_study").run, str(tmp_path / "jax"))
    res = _quiet(mod.run, str(tmp_path / "port"), device="cpu")
    errs = {"feat_std": float(np.max(np.abs(res["feat_std"] - res_j["feat_std"])))}
    for split in ("train", "valid"):
        assert res["one_hot"][split]["unique"] == res_j["one_hot"][split]["unique"]
        errs[split] = abs(res["one_hot"][split]["max_snap_m"]
                          - res_j["one_hot"][split]["max_snap_m"])
    record_property("max_abs", errs)
    assert max(errs.values()) < 1e-6, errs
    assert res["patches"] == res_j["patches"]
    # the conclusion (tests/test_examples.py)
    for split in ("train", "valid"):
        assert res["one_hot"][split]["unique"], split
    assert int((res["feat_std"] > 0.05).sum()) >= len(res["feat_std"]) // 2
    assert res["patches"]["disjoint"] and res["patches"]["covered"] > 0.9
    assert (tmp_path / "port" / "floor_plan.png").exists()
    assert (tmp_path / "port" / "rooms_3d.png").exists()


def test_compare_flops_matches_jax(tmp_path, capsys):
    from diffgfdn_torch.examples import compare_flops as mod

    jout, out = tmp_path / "jax.png", tmp_path / "port.png"
    _jax_study("compare_flops").main(["--out", str(jout)])
    jax_text = capsys.readouterr().out
    mod.main(["--out", str(out)])
    text = capsys.readouterr().out
    assert text.replace(str(out), "") == jax_text.replace(str(jout), "")
    assert out.exists()
    table = mod.cost_table()
    assert [name for name, _ in table["rows"]][0] == "full-band GFDN, GEQ absorption"


def test_chip_smoke_carries_the_colorless_study_draw_of_jax():
    """``chip_smoke.py`` trains the colorless study on the card from the JAX
    study's own draws (ROADMAP C25): they must be exactly JAX's."""
    from diffgfdn_torch.examples.colorless_output_study import GROUP_DELAYS, NUM_EVAL
    from diffgfdn_tpu.models.colorless import ColorlessFDN

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    z = np.exp(1j * np.linspace(0.0, np.pi, NUM_EVAL, endpoint=False)).astype(np.complex64)
    for g, (delays, carried) in enumerate(zip(GROUP_DELAYS, chip_smoke.colorless_jax_init())):
        want = _numpy_tree(ColorlessFDN(sample_rate=8000.0, delays=delays).init(
            jax.random.PRNGKey(g), jnp.asarray(z[:16])))
        got_leaves, got_def = jax.tree_util.tree_flatten(carried)
        want_leaves, want_def = jax.tree_util.tree_flatten(want)
        assert got_def == want_def
        for a, b in zip(got_leaves, want_leaves):
            assert a.dtype == b.dtype and np.array_equal(a, b)
