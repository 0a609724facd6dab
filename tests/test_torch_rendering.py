"""6DoF rendering against the JAX package on the inputs of JAX's own tests
(tests/test_inference.py): the host paths (the moving-receiver and binaural
hop loops, loudness, the early-part splice) within 1e-9 of the peak; the
batched render on the CPU (``backend="device"``) within 1e-5 of the peak of
JAX's ``backend="jax"`` and 1e-4 of its host loop; the dictionary program
within 2e-5 of the einsum program; a walk of the multi render within 1e-5 of
its single render. The moving receiver's ``animate_trajectory`` writes its
animation, as JAX's ``animate_moving_listener`` does.
"""

import numpy as np
import pytest

from diffgfdn_torch.data import SpatialThreeRoomDataset, ThreeRoomDataset
from diffgfdn_torch.inference import rendering as port
from diffgfdn_tpu.data import generate_three_room_pickle
from diffgfdn_tpu.data import ThreeRoomDataset as JaxThreeRoomDataset
from diffgfdn_tpu.data.spatial_dataset import generate_spatial_three_room_pickle
from diffgfdn_tpu.data.spatial_dataset import SpatialThreeRoomDataset as JaxSpatialDataset
from diffgfdn_tpu.inference import rendering as ref

HOST_TOL = 1e-9  # max abs error / peak
DEVICE_TOL = 1e-5  # batched render vs JAX's batched render
LOOP_TOL = 1e-4  # batched render vs the host loop (float32 vs float64)
DICT_TOL = 2e-5  # dictionary program vs einsum program
MULTI_TOL = 1e-5  # a walk of the multi render vs its single render
HOP_MS = 50


def _err(got, want, peak=None):
    peak = np.abs(want).max() if peak is None else peak
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / peak)


@pytest.fixture(scope="module")
def spatial(tmp_path_factory):
    path = generate_spatial_three_room_pickle(
        tmp_path_factory.mktemp("rendering") / "s.pkl", grid_spacing_m=1.2, rir_len_s=0.1,
        decay_times=(0.03, 0.05, 0.04),
    )
    jax_room, room = JaxSpatialDataset(path), SpatialThreeRoomDataset(path)
    assert np.array_equal(jax_room.rirs, room.rirs)
    return jax_room, room


@pytest.fixture(scope="module")
def three_room(tmp_path_factory):
    path = generate_three_room_pickle(
        tmp_path_factory.mktemp("rendering3") / "srirs.pkl", num_rec_per_room=2,
        rir_len_s=0.2, decay_times=(0.05, 0.08, 0.06),
    )
    return JaxThreeRoomDataset(path, nfft=2048), ThreeRoomDataset(path, nfft=2048)


def _hrir_sh():
    """An order-2 HRIR-SH set: decaying noise per SH channel and ear."""
    rng = np.random.RandomState(3)
    return rng.randn(9, 2, 32) * np.exp(-np.arange(32) / 8.0)


def _walk(room, n_hops, seed, whole=True):
    rng = np.random.RandomState(seed)
    pos = np.tile(room.receiver_position[:3], (n_hops // 3 + 1, 1))[:n_hops]
    oris = np.stack([np.linspace(0, np.pi, n_hops), np.linspace(-0.2, 0.3, n_hops)], axis=-1)
    hop = int(room.sample_rate * HOP_MS / 1000)
    stim = rng.randn(n_hops * hop - 37).astype(np.float32)  # tiled to the walk's length
    return dict(rec_pos_list=pos, orientation_list=oris, stimulus=stim, hrir_sh=_hrir_sh(),
                update_ms=HOP_MS, use_whole_rir=whole)


def _renderers(spatial, **kw):
    jax_room, room = spatial
    return (ref.BinauralDynamicRendering(jax_room, **kw),
            port.BinauralDynamicRendering(room, device="cpu", **kw))


def test_loudness_and_fades_match_jax(record_property):
    rng = np.random.RandomState(0)
    sig = 0.01 * rng.randn(int(8000.0 * 3), 2)
    got, want = port.integrated_loudness(sig, 8000.0), ref.integrated_loudness(sig, 8000.0)
    assert abs(got - want) <= 1e-9
    err = _err(port.normalise_loudness(sig, 8000.0), ref.normalise_loudness(sig, 8000.0))
    record_property("normalise_loudness_err", err)
    assert err <= HOST_TOL
    assert abs(port.integrated_loudness(port.normalise_loudness(sig[:, 0], 8000.0), 8000.0)
               + 18.0) < 0.5
    for fade_out in (False, True):
        for uncorr in (False, True):
            assert np.array_equal(port.fade_windows(160, fade_out, uncorr),
                                  ref.fade_windows(160, fade_out, uncorr))


def test_add_direct_and_early_path_matches_jax(three_room, record_property):
    jax_room, room = three_room
    late = np.random.RandomState(1).randn(*room.rirs.shape) * 0.1
    args = (room.rirs, room.receiver_position, late, room.receiver_position[::-1].copy(),
            room.sample_rate)
    got = port.add_direct_and_early_path(*args, mixing_time_ms=50.0)
    want = ref.add_direct_and_early_path(*args, mixing_time_ms=50.0)
    err = _err(got, want)
    record_property("max_abs_err_over_peak", err)
    assert got.shape == want.shape and err <= HOST_TOL


@pytest.mark.parametrize("whole", [True, False], ids=["whole_rir", "late_part"])
def test_moving_receiver_overlap_add_matches_jax(three_room, whole, record_property, tmp_path):
    jax_room, room = three_room
    rng = np.random.RandomState(0)
    stim = rng.randn(1600).astype(np.float32)
    pos = room.receiver_position[[0, 0, 1, 3, 2]]
    got = port.DynamicRenderingMovingReceiver(room, pos, stim, update_ms=50)
    want = ref.DynamicRenderingMovingReceiver(jax_room, pos, stim, update_ms=50)
    assert np.array_equal(got.rec_idxs, want.rec_idxs)
    err = _err(got.filter_overlap_add(use_whole_rir=whole),
               want.filter_overlap_add(use_whole_rir=whole))
    record_property("max_abs_err_over_peak", err)
    assert err <= HOST_TOL
    walk = tmp_path / "walk.mp4"
    got.animate_trajectory(str(walk), yaw_angles=np.linspace(0.0, np.pi / 2, len(pos)))
    assert walk.exists() or walk.with_suffix(".gif").exists()


@pytest.mark.parametrize("whole", [True, False], ids=["whole_rir", "late_part"])
def test_binaural_host_loop_matches_jax(spatial, whole, record_property):
    jax_rend, rend = _renderers(spatial, **_walk(spatial[1], 5, 1, whole))
    assert np.array_equal(rend._rtf_inv, jax_rend._rtf_inv)
    # twice: the second call starts from the first call's smoothing state
    for call, stream in enumerate(
            (rend.stream_host, lambda: rend.binaural_filter_overlap_add(backend="host"))):
        err = _err(stream(), jax_rend.binaural_filter_overlap_add())
        record_property(f"host_loop_call{call}_err", err)
        assert err <= HOST_TOL
    with pytest.raises(ValueError, match="backend"):
        rend.binaural_filter_overlap_add(backend="jax")


@pytest.mark.parametrize("n_hops", [1, 5, 9])
def test_device_render_matches_jax_and_the_host_loop(spatial, n_hops, record_property):
    """``backend="device"`` against JAX's ``backend="jax"`` and against the
    host loop from a fresh renderer (the end-truncated crossfade tails: at
    8 kHz a hop is 400 samples and a segment 1423), through both programs."""
    jax_rend, rend = _renderers(spatial, **_walk(spatial[1], n_hops, 2))
    host = ref.BinauralDynamicRendering(spatial[0], **_walk(spatial[1], n_hops, 2))
    loop = host.binaural_filter_overlap_add()
    peak = np.abs(loop).max()
    outs = {}
    for dict_path in (False, True):
        jax_rend.dict_path = rend.dict_path = dict_path
        outs[dict_path] = rend.binaural_filter_overlap_add()  # backend="device"
        want = jax_rend.binaural_filter_overlap_add(backend="jax")
        assert outs[dict_path].shape == loop.shape and outs[dict_path].dtype == np.float64
        errs = {"vs_jax": _err(outs[dict_path], want, peak),
                "vs_host_loop": _err(outs[dict_path], loop, peak)}
        for name, err in errs.items():
            record_property(f"{'dict' if dict_path else 'einsum'}_{name}", err)
        assert errs["vs_jax"] <= DEVICE_TOL and errs["vs_host_loop"] <= LOOP_TOL, errs
    err = _err(outs[True], outs[False], peak)
    record_property("dict_vs_einsum", err)
    assert err <= DICT_TOL


def test_dictionary_policy_matches_jax(spatial, monkeypatch):
    jax_rend, rend = _renderers(spatial, **_walk(spatial[1], 5, 3))
    assert rend._dict_nbytes() == jax_rend._dict_nbytes()
    assert rend._use_dict_path() and jax_rend._use_dict_path()
    monkeypatch.setenv("DIFFGFDN_BINAURAL_DICT_MB", str(rend._dict_nbytes() / 2 ** 21))
    assert not rend._use_dict_path() and not jax_rend._use_dict_path()
    rend.dict_path = True
    assert rend._use_dict_path()
    j = rend._rtf_uniq.shape[0] * 81
    assert tuple(rend._ensure_dict_consts().shape) == (j, 2 * (rend._conv_nfft() // 2 + 1) * 2)


@pytest.mark.parametrize("dict_path", [False, True], ids=["einsum", "dictionary"])
def test_multi_render_matches_jax_and_single(spatial, dict_path, record_property):
    """Row 0 walks the renderer's own path; row 1 another orientation list
    and receiver path, against a fresh renderer walking it."""
    n_hops = 4
    kw = _walk(spatial[1], n_hops, 1)
    jax_rend, rend = _renderers(spatial, **kw)
    jax_rend.dict_path = rend.dict_path = dict_path
    rng = np.random.RandomState(4)
    hop = rend.hop_size
    oris2 = np.stack([np.linspace(np.pi, 0, n_hops), np.full(n_hops, 0.2)], axis=-1)
    rec2 = np.array([1, 0, 1, 0])
    stim2 = rng.randn(n_hops * hop).astype(np.float32)
    stimuli = np.stack([rend.extended_stimulus, stim2])
    args = (stimuli, np.stack([kw["orientation_list"], oris2]),
            np.stack([np.arange(n_hops), rec2]))
    multi = rend.binaural_filter_overlap_add_multi(*args)
    want = jax_rend.binaural_filter_overlap_add_multi(*args)
    single = rend.binaural_filter_overlap_add(backend="device")
    kw2 = dict(kw, rec_pos_list=kw["rec_pos_list"][rec2], orientation_list=oris2, stimulus=stim2)
    single2 = port.BinauralDynamicRendering(spatial[1], device="cpu", **kw2)
    single2.dict_path = dict_path
    errs = {"vs_jax": _err(multi, want),
            "row0_vs_single": _err(multi[0], single),
            "row1_vs_single": _err(multi[1], single2.binaural_filter_overlap_add(backend="device")),
            "default_vs_jax": _err(rend.binaural_filter_overlap_add_multi(stimuli),
                                   jax_rend.binaural_filter_overlap_add_multi(stimuli))}
    for name, err in errs.items():
        record_property(name, err)
    assert multi.shape == (2, n_hops * hop, 2) and np.isfinite(multi).all()
    assert errs["vs_jax"] <= DEVICE_TOL and errs["default_vs_jax"] <= DEVICE_TOL, errs
    assert max(errs["row0_vs_single"], errs["row1_vs_single"]) <= MULTI_TOL, errs

