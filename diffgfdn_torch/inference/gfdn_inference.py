"""GFDN inference: serve RIRs from a trained checkpoint (port of ``inference/gfdn_inference.py``).

Given a checkpoint (the JAX package's format, ``training/checkpoints.py``)
and dataset receiver indices, run the model over the receivers' positions
and irfft the transfer function to RIRs of shape (B, nfft)
(:class:`InferDiffGFDN`), or run the loop in the time domain with no time
aliasing (:func:`make_time_domain_synthesis_fn`). A directional model
serves SH-domain RIRs (B, (ambi_order + 1)^2, nfft) from a spatial dataset.
A model warm-started from colorless prototypes is rebuilt from their cached
pickles (they fix its io gains), retraining only missing ones.

Subband models (one per octave band) are merged into broadband RIRs by
their reconstructing filterbank (:func:`infer_all_octave_bands`; directional
band models into broadband SH-domain SRIRs,
:func:`infer_all_octave_bands_directional`), or compared with the measured
RIRs' EDCs on the card without any RIR reaching the host
(:func:`broadband_edc_errors_device`). Their time-domain synthesis and
merge are not ported yet (ROADMAP A11).
"""

import logging
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Union

import numpy as np
from scipy.signal import fftconvolve
import torch

from ..config.schema import DiffGFDNConfig
from ..data.batching import arrays_from_room_dataset
from ..data.room_dataset import RoomDataset
from ..data.spatial_dataset import arrays_from_spatial_dataset, SpatialRoomDataset
from ..kernels.tdgfdn import delay_line_outputs, delay_line_outputs_filtered, filter_bank_from_sos
from ..models import DiffDirectionalFDNVarReceiverPos, DiffGFDNVarReceiverPos
from ..models.gain_heads import expand_groups_to_delay_lines
from ..ops.basic import db, ms_to_samps, schroeder_backward_int
from ..ops.filterbanks import reconstructing_fractional_octave_bands
from ..training.build import build_gfdn_model, colorless_result_path
from ..training.checkpoints import load_latest_checkpoint
from ..training.solver import colorless_prototypes
from ..training.trainer import target_rirs, upload_model_inputs
from ..utils.device import resolve_device
from ..utils.params import load_jax_params

logger = logging.getLogger("diffgfdn_torch")

# the batch entries DiffGFDNVarReceiverPos reads
MODEL_INPUTS = ("z_values", "listener_position", "norm_listener_position",
                "target_early_response")
# the batch entries DiffDirectionalFDNVarReceiverPos reads
DIRECTIONAL_INPUTS = ("z_values", "listener_position", "norm_listener_position")


def make_rir_synthesis_fn(
    model: torch.nn.Module, reduced_pole_radius: float = 1.0,
    external_amplitudes: bool = False,
) -> Callable[..., torch.Tensor]:
    """``synth(batch) -> RIRs (B, nfft)`` float32, on the batch's device
    ((B, L, nfft) SH-domain RIRs for a directional model).

    irffts the model's transfer function and undoes sampling outside the
    unit circle with a growing exponential. Forward only: no autograd graph.
    ``external_amplitudes=True`` makes it ``synth(batch, amplitudes)``: the
    (B, num_groups) amplitudes replace the scalar head's per-group gains.
    """

    @torch.no_grad()
    def synth(batch: Dict[str, torch.Tensor], *amplitudes: torch.Tensor) -> torch.Tensor:
        if len(amplitudes) != int(external_amplitudes):
            raise TypeError(f"synth takes {int(external_amplitudes)} amplitude argument(s)")
        h = model(batch, *amplitudes)
        n = 2 * (h.shape[-1] - 1)
        rir = torch.fft.irfft(h, n, dim=-1)
        if reduced_pole_radius != 1.0:
            growth = torch.tensor(1.0 / reduced_pole_radius, dtype=torch.float32)
            rir = rir * torch.pow(
                growth, torch.arange(n, dtype=torch.float32)
            ).to(rir.device)
        return rir

    return synth


def make_time_domain_synthesis_fn(
    model: torch.nn.Module, num_samples: int
) -> Callable[[Dict[str, torch.Tensor]], torch.Tensor]:
    """Alias-free time-domain RIR synthesis from a trained model.

    Returns ``synth(batch) -> (B, num_samples)`` float32 on the model's
    device. The feedback loop runs once, here, as the exact block-feedforward
    recursion (``kernels/tdgfdn.py``): its delay-line impulse response is
    position-independent, so the infinite tail has no time aliasing whatever
    its length (the frequency-sampled path wraps the energy beyond nfft).
    Scalar absorption runs kernel B7 on the card; GEQ (SOS) absorption runs
    the exact block state-space path. Per batch:

    * scalar heads: the per-position mix is one (B, N) x (N, T) product;
    * SVF heads: the per-group output filters (short IIRs) are applied by a
      zero-padded rFFT product at nfft2 = next_pow2(num_samples + 4096);
    * directional models: the loop runs on the TRANSPOSED feedback matrix
      (the model reads q = P^T b, and P^T = (D Gamma^-1 - A^T)^-1 since the
      delay and absorption part is diagonal), and each position's SH weights
      mix the line outputs per SH channel: (B, L, num_samples) SRIRs.

    The direct part is not added (renderers splice it separately). ``batch``
    holds ``listener_position`` and ``norm_listener_position`` (B, 3) on the
    model's device.
    """
    directional = isinstance(model, DiffDirectionalFDNVarReceiverPos)
    if not (directional or isinstance(model, DiffGFDNVarReceiverPos)):
        raise NotImplementedError(
            f"time-domain synthesis of {type(model).__name__} is not ported yet (ROADMAP A10)"
        )
    fl = model.feedback_loop
    nper = model.num_delay_lines_per_group
    delays = model.delays
    with torch.no_grad():
        a = fl.coupled_feedback_matrix()
        if directional:
            a = a.T.contiguous()
        b = model.input_gains[:, 0]
        impulse = torch.zeros(num_samples, dtype=torch.float32, device=b.device)
        impulse[0] = 1.0
        if fl.use_absorption_filters:
            bank = filter_bank_from_sos(fl.sos_coeffs_host, delays)
            y = delay_line_outputs_filtered(delays, bank, a, b, impulse)
        else:
            y = delay_line_outputs(delays, fl.gamma_scalar(), a, b, impulse)  # (T, N)

    if directional:
        y_gl = y.reshape(num_samples, model.num_groups, nper)

        @torch.no_grad()
        def synth(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
            # rir_sh[b, l, t] = sum_g w[b, g, l] y[t, g, l]
            return torch.einsum("bgl,tgl->blt", model.sh_weights(batch), y_gl)

        return synth

    if not model.use_svf_in_output:
        @torch.no_grad()
        def synth(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
            c = expand_groups_to_delay_lines(model.output_scalars(batch), nper)
            return (y @ (c * model.output_gains[:, 0]).T).T

        return synth

    # SVF heads: the loop part above is already alias-free; the output
    # filters multiply its spectrum at a generously padded length. The lines
    # of a group share the group's filter, so the output gains pool the
    # line spectra per group first: w[f, g] = sum_{n in g} c_n Y[f, n]
    nfft2 = 1 << int(np.ceil(np.log2(num_samples + 4096)))
    z2 = torch.from_numpy(
        np.exp(1j * np.linspace(0.0, np.pi, nfft2 // 2 + 1)).astype(np.complex64)
    ).to(y.device)
    with torch.no_grad():
        yf = torch.fft.rfft(y, nfft2, dim=0)  # (F2, N)
        c = model.output_gains[:, 0].to(torch.complex64)
        w = (yf * c).reshape(-1, model.num_groups, nper).sum(dim=-1)  # (F2, G)

    @torch.no_grad()
    def synth(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        r = model.output_filters({**batch, "z_values": z2})  # (B, G, F2)
        h = torch.einsum("bgf,fg->bf", r, w)
        return torch.fft.irfft(h, nfft2, dim=-1)[:, :num_samples]

    return synth


class InferDiffGFDN:
    """Serve RIRs at dataset receiver positions from a trained checkpoint.

    ``params``: a flax-layout parameter tree (as a checkpoint holds it);
    None loads the newest checkpoint under ``trainer_config.train_dir``.
    ``device`` defaults to CUDA and raises without a card unless the caller
    passes ``device="cpu"``. ``variant="directional"`` takes a spatial
    dataset and builds the model as the directional solver does, for the
    dataset's directions: it serves (B, L, nfft) SH-domain RIRs. (The JAX
    package's class cannot build that model: it passes no directions.)
    """

    def __init__(
        self,
        config: DiffGFDNConfig,
        room_data: RoomDataset,
        variant: str = "var_receiver",
        params: Optional[Dict] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        self.device = resolve_device(device)
        tc = config.trainer_config
        self.config = config
        self.room_data = room_data
        directional = variant == "directional"
        self.model = build_gfdn_model(
            config,
            common_decay_times=room_data.common_decay_times,
            band_centre_hz=room_data.band_centre_hz,
            variant=variant,
            device=self.device,
            desired_directions=room_data.desired_directions if directional else None,
            colorless_params=self._colorless_params(config, room_data),
        )
        if params is None:
            params = load_latest_checkpoint(tc.train_dir, tc.max_epochs)
            if params is None:
                raise FileNotFoundError(f"no checkpoint under {tc.train_dir}")
        load_jax_params(self.model, params)
        self.model.eval()
        self._synth = make_rir_synthesis_fn(self.model, tc.reduced_pole_radius)
        self._amp_synth = None  # built on the first rirs_with_amplitudes call
        self._inputs = DIRECTIONAL_INPUTS if directional else MODEL_INPUTS
        to_arrays = arrays_from_spatial_dataset if directional else arrays_from_room_dataset
        self.arrays = to_arrays(
            room_data,
            new_sampling_radius=(
                None if tc.reduced_pole_radius == 1.0 else 1.0 / tc.reduced_pole_radius
            ),
        )
        # a subband model trained against band-filtered targets: its output is
        # scaled by the band filter's energy (subband_energy_compensation)
        self.subband_filter_norm_factor = 1.0
        spc = tc.subband_process_config
        if spc is not None:
            filters, centers = reconstructing_fractional_octave_bands(
                num_fractions=spc.num_fraction_octaves,
                frequency_range=spc.frequency_range,
                n_samples=2 ** 12,
                sampling_rate=room_data.sample_rate,
            )
            band = filters[int(np.argmin(np.abs(centers - spc.centre_frequency)))]
            self.subband_filter_norm_factor = subband_energy_compensation(band)

    def _colorless_params(self, config: DiffGFDNConfig, room_data: RoomDataset):
        """The colorless prototypes the model was trained from, rebuilt as the
        solver built them (they fix the io gains, which the checkpoint does not
        hold): the saved results at ``saved_param_path``, else those cached under
        ``<train_dir>/colorless-fdn``, retraining only missing groups."""
        ccfg = config.colorless_fdn_config
        if ccfg.use_colorless_prototype and not ccfg.load_fixed_parameters:
            colorless_dir = Path(config.trainer_config.train_dir) / "colorless-fdn"
            missing = [g + 1 for g in range(config.num_groups)
                       if not colorless_result_path(colorless_dir, g).exists()]
            if missing:
                logger.warning(
                    "colorless prototype pickles missing for group(s) %s under %s: "
                    "retraining them now; if this checkpoint was trained elsewhere, copy "
                    "its colorless-fdn/ directory instead (retrained io gains may not match "
                    "the checkpoint)", missing, colorless_dir)
        return colorless_prototypes(config, room_data.num_freq_bins, self.device)

    def _device_batch(self, idx: np.ndarray) -> Dict[str, torch.Tensor]:
        """The model's inputs only: the late and full target planes are never read."""
        batch = {k: getattr(self.arrays, k)[idx] for k in self._inputs if k != "z_values"}
        batch["z_values"] = self.arrays.z_values  # shared by every receiver
        return {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}

    def _batched_synth(
        self, synth, rec_indices: np.ndarray, batch_size: int,
        amplitudes: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Run ``synth`` over the indices in batches. The last batch is padded
        to ``batch_size`` with its first index (and amplitude row) and
        trimmed, so every call runs full batches."""
        rec_indices = np.asarray(rec_indices)
        outs = []
        for k in range(0, len(rec_indices), batch_size):
            idx = rec_indices[k : k + batch_size]
            n_real = len(idx)
            pad = batch_size - n_real
            if pad:
                idx = np.concatenate([idx, idx[:1].repeat(pad)])
            args = ()
            if amplitudes is not None:
                amp = amplitudes[k : k + batch_size]
                if pad:
                    amp = np.concatenate([amp, amp[:1].repeat(pad, axis=0)])
                args = (torch.from_numpy(amp).to(self.device),)
            rir = synth(self._device_batch(idx), *args)
            outs.append(rir[:n_real].cpu().numpy())
        return self.subband_filter_norm_factor * np.concatenate(outs, axis=0)

    def rirs_at(self, rec_indices: np.ndarray, batch_size: int = 32) -> np.ndarray:
        """Synthesize RIRs (len(rec_indices), nfft) at the dataset receiver
        indices ((len(rec_indices), L, nfft) for a directional model)."""
        return self._batched_synth(self._synth, rec_indices, batch_size)

    def rirs_with_amplitudes(
        self, rec_indices: np.ndarray, amplitudes: np.ndarray, batch_size: int = 32
    ) -> np.ndarray:
        """Synthesize with externally provided common-slope amplitudes.

        ``amplitudes`` (len(rec_indices), num_groups) replace the scalar
        head's per-group gains (driving a trained GFDN from a common-slopes
        model's amplitude predictions). Scalar-head models only.
        """
        if not isinstance(self.model, DiffGFDNVarReceiverPos) or self.model.use_svf_in_output:
            raise ValueError(
                "direct CS-amplitude injection needs a scalar-head model "
                "(use_svf_in_output=False)"
            )
        rec_indices = np.asarray(rec_indices)
        amplitudes = np.asarray(amplitudes, np.float32)
        expected = (len(rec_indices), self.model.num_groups)
        if amplitudes.shape != expected:
            raise ValueError(
                f"amplitudes must have shape {expected} "
                f"(one row per receiver index), got {amplitudes.shape}"
            )
        if self._amp_synth is None:
            self._amp_synth = make_rir_synthesis_fn(
                self.model, self.config.trainer_config.reduced_pole_radius,
                external_amplitudes=True,
            )
        return self._batched_synth(self._amp_synth, rec_indices, batch_size, amplitudes)

    def head_outputs(self, rec_indices: np.ndarray) -> Dict[str, np.ndarray]:
        """Per-position head outputs (gains, or SVF parameters and biquads) at the indices."""
        with torch.no_grad():
            out = self.model.head_outputs(self._device_batch(np.asarray(rec_indices)))
        return {k: v.cpu().numpy() for k, v in out.items()}


def subband_energy_compensation(band_filter: np.ndarray) -> float:
    """Energy compensation for training on band-filtered targets: the L2
    norm of the band filter's FIR coefficients."""
    return float(np.sqrt(np.sum(np.asarray(band_filter) ** 2)))


def merge_subband_rirs(band_rirs: Iterable[np.ndarray], band_filters: np.ndarray) -> np.ndarray:
    """Filter each band's synthesized RIRs with its reconstructing filter
    and sum across bands -> broadband RIRs (float64).

    ``band_rirs``: (..., T) arrays, one per band (any leading dims), in a
    list or produced one at a time by an iterator (then only one band's
    RIRs are held at once); ``band_filters``: (num_bands, filt_len). The
    group delay of the linear-phase filterbank is compensated.
    """
    filt_len = band_filters.shape[-1]
    delay = filt_len // 2
    out = None
    for b, rirs in enumerate(band_rirs):
        if out is None:
            out = np.zeros(rirs.shape)
        shape = (1,) * (rirs.ndim - 1) + (filt_len,)
        filtered = fftconvolve(rirs, band_filters[b].reshape(shape), mode="full", axes=-1)
        out += filtered[..., delay : delay + rirs.shape[-1]]
    return out


def band_reconstruction_filters(
    configs: List[DiffGFDNConfig], sample_rate: float, fir_len: int
) -> np.ndarray:
    """The reconstructing octave filter (fir_len,) of each config's band,
    matched by the nearest centre frequency: (len(configs), fir_len)."""
    centre_freqs = [c.trainer_config.subband_process_config.centre_frequency for c in configs]
    filters, centers = reconstructing_fractional_octave_bands(
        num_fractions=1,
        frequency_range=configs[0].trainer_config.subband_process_config.frequency_range,
        n_samples=fir_len,
        sampling_rate=sample_rate,
    )
    return filters[[int(np.argmin(np.abs(centers - fc))) for fc in centre_freqs]]


def infer_all_octave_bands(
    configs: List[DiffGFDNConfig],
    room_data: RoomDataset,
    rec_indices: np.ndarray,
    variant: str = "var_receiver",
    fir_len: int = 2 ** 12,
    device: Union[str, torch.device] = "cuda",
) -> np.ndarray:
    """Broadband RIRs (len(rec_indices), nfft) from one subband model per
    octave band: each band model's RIRs (from its newest checkpoint), band
    filtered by the reconstructing filterbank and summed on the host
    (:func:`merge_subband_rirs`), one band at a time.
    ``variant="directional"`` takes a spatial dataset and returns
    :func:`infer_all_octave_bands_directional`'s (P, L, nfft) SRIRs."""
    if variant == "directional":
        return infer_all_octave_bands_directional(configs, room_data, rec_indices,
                                                  fir_len=fir_len, device=device)
    filters = band_reconstruction_filters(configs, room_data.sample_rate, fir_len)
    return merge_subband_rirs(
        (InferDiffGFDN(cfg, room_data, variant=variant, device=device).rirs_at(rec_indices)
         for cfg in configs), filters)


def infer_all_octave_bands_directional(
    configs: List[DiffGFDNConfig],
    room_data: SpatialRoomDataset,
    rec_indices: np.ndarray,
    convert_to_ambisonics: bool = False,
    fir_len: int = 2 ** 12,
    device: Union[str, torch.device] = "cuda",
) -> np.ndarray:
    """Broadband SH-domain SRIRs (len(rec_indices), (ambi_order + 1)^2, nfft)
    float64 from one directional model per octave band.

    Each band is served by ``InferDiffGFDN(variant="directional")`` from its
    newest checkpoint (the model built as the directional solver builds
    it), band filtered by the reconstructing filterbank and added to the
    sum on the host, one band at a time (:func:`merge_subband_rirs`).

    The merged SRIRs are already in the SH domain, so
    ``convert_to_ambisonics=True`` raises ``ValueError``: the JAX package
    would hand them to ``convert_directional_rirs_to_ambisonics``, which
    reads their axis as the 12 directions (ROADMAP C12).
    """
    if convert_to_ambisonics:
        raise ValueError(
            "the directional octave-band merge returns SH-domain SRIRs already: there are no "
            "directional responses to convert to ambisonics (ROADMAP C12)"
        )
    filters = band_reconstruction_filters(configs, room_data.sample_rate, fir_len)
    return merge_subband_rirs(
        (InferDiffGFDN(cfg, room_data, variant="directional", device=device)
         .rirs_at(rec_indices) for cfg in configs), filters)


@torch.no_grad()
def broadband_edc_errors_device(
    configs: List[DiffGFDNConfig],
    room_data: RoomDataset,
    rec_indices: Optional[np.ndarray] = None,
    batch_size: int = 32,
    fir_len: int = 2 ** 12,
    device: Union[str, torch.device] = "cuda",
) -> np.ndarray:
    """Per-receiver mean |delta EDC| (dB) of the broadband reconstruction,
    computed on the device: (len(rec_indices),).

    The dataset's model inputs and target RIRs are uploaded once and each
    receiver batch is gathered on the device. Per batch every band model's
    H is multiplied by its delay-compensated reconstructing filter's
    response (the frequency-domain counterpart of
    :func:`infer_all_octave_bands`' convolution and group-delay trim) and
    by its energy compensation, summed over the bands and irfft'd; its
    Schroeder EDC from 20 ms to the longest decay time is compared with the
    target's. The errors stay on the device until the one read at the end.
    """
    dev = resolve_device(device)
    if rec_indices is None:
        rec_indices = np.arange(room_data.num_rec)
    rec_indices = np.asarray(rec_indices)
    fs = room_data.sample_rate
    nfft = room_data.num_freq_bins
    f = nfft // 2 + 1
    filters = band_reconstruction_filters(configs, fs, fir_len)
    delay = filters.shape[-1] // 2
    fresp = np.fft.rfft(filters, nfft, axis=-1) * np.exp(2j * np.pi * np.arange(f) * delay / nfft)
    infers = [InferDiffGFDN(cfg, room_data, device=dev) for cfg in configs]
    # each band's filter response times its energy compensation, (bands, F)
    band_fr = torch.as_tensor(
        (np.stack([i.subband_filter_norm_factor for i in infers])[:, None] * fresp)
        .astype(np.complex64), device=dev,
    )
    arrays = infers[0].arrays
    data = upload_model_inputs(arrays, dev)
    targets = target_rirs(arrays, nfft, dev)
    mix = ms_to_samps(20.0, fs)
    end = min(ms_to_samps(float(np.max(room_data.common_decay_times)) * 1e3, fs), nfft)
    rpr = configs[0].trainer_config.reduced_pole_radius
    growth = None
    if rpr != 1.0:
        growth = torch.pow(torch.tensor(1.0 / rpr, dtype=torch.float32),
                           torch.arange(nfft, dtype=torch.float32)).to(dev)
    n = len(rec_indices)
    pad = (-n) % batch_size
    idx_all = torch.as_tensor(
        np.concatenate([rec_indices, rec_indices[:1].repeat(pad)]), dtype=torch.long, device=dev
    )
    errs = []
    for idx in idx_all.reshape(-1, batch_size):
        batch = {k: v if k == "z_values" else v[idx] for k, v in data.items()}
        h = sum(infer.model(batch) * band_fr[b] for b, infer in enumerate(infers))
        rir = torch.fft.irfft(h, nfft, dim=-1)
        if growth is not None:
            rir = rir * growth
        a_edc = db(schroeder_backward_int(rir[..., mix:end]), is_squared=True)
        t_edc = db(schroeder_backward_int(targets[idx][..., mix:end]), is_squared=True)
        errs.append(torch.mean(torch.abs(a_edc - t_edc), dim=-1))
    return torch.cat(errs).cpu().numpy()[:n]
