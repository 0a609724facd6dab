"""Time-domain GFDN core: the block-feedforward recursion and the exact filtered path.

Port of ``diffgfdn_tpu/kernels/tdgfdn.py``. The FDN recursion

    y_i[n] = gamma_i * x_i[n - m_i];   x[n] = A y[n] + b u[n]

has no feedback inside a block of L <= min(m) samples, so it runs as T / L
steps of (gather the delayed history, mix, write the block). The result is
exact, not an approximation.

* :func:`delay_line_outputs` replaces ``tdgfdn.py::_tdgfdn_kernel``: CPU
  tensors take :func:`delay_line_outputs_plain`; CUDA tensors launch
  ``csrc/tdgfdn.cu`` whatever the delays, counted in
  ``delay_line_outputs.launches``: its history is a ring in shared memory
  where the ring fits, else in device memory, and above N = 12 lines its
  coefficients are in shared memory, as :func:`kernel_plan` decides from
  the sizes alone. The JAX package picks its Pallas kernel
  by a measured policy with a VMEM-budget fallback to its scan; both exist
  for the TPU alone, and here the tensors' device decides;
* :func:`delay_line_outputs_filtered`: per-line SOS/IIR absorption filters
  by block state-space processing, and FILTER-mode polynomial coupling.
  Plain PyTorch on every device: the JAX package has no kernel for it;
* the block filter-bank constants: host float64 numpy, copied verbatim.

Per-position RIRs follow as one matrix product Y @ C^T over the batch of
output-gain vectors.
"""

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import _build
from .dispatch import runs_kernel

MAX_N = 32  # the kernel's template instantiations
MAX_THREADS = 256  # one thread block (up to 255 registers a thread)
GROUP = 2  # consecutive samples a thread of the ring variant takes at once
WARP = 32
# steps of the ring variant: a multiple of this many samples fills whole
# warps evenly over an SM's 4 schedulers (where min(delay) allows)
BALANCED_BLOCK = GROUP * WARP * 4
MAX_KERNEL_BLOCK = 2048  # samples per step of the kernels
# csrc/tdgfdn.cu's variants: history in device memory, a ring in shared
# memory (both with the coefficients in registers), and the history in
# device memory with the coefficients in shared memory
HIST, RING, LINES = 0, 1, 2
# the most lines whose N^2 + 2N coefficients fit a thread's registers (the
# ring and hist variants; csrc/tdgfdn.cu kRegisterLines)
REGISTER_LINES = 12
LINES_THREADS = 768  # one block of the LINES variant (up to 85 registers a thread)
_SIGNATURES = {
    "diffgfdn_tdgfdn_f32": [ctypes.c_void_p] * 4
    + [ctypes.POINTER(ctypes.c_int), ctypes.c_longlong]
    + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    "diffgfdn_tdgfdn_smem_limit": [ctypes.c_int],
}
_smem_limits = {}


def _block_size(delays: Tuple[int, ...]) -> int:
    """The plain version's block: the largest power of two not exceeding
    the minimum delay."""
    m_min = int(min(delays))
    return 1 << max(0, (m_min.bit_length() - 1))


class KernelPlan(NamedTuple):
    """How ``csrc/tdgfdn.cu`` runs a delay set: ``variant`` (HIST, RING or
    LINES), ``block`` samples per step, ``threads`` per block and ``ring``
    slots per line (0 but for RING)."""

    variant: int
    block: int
    threads: int
    ring: int


def ring_bytes(n: int, ring: int) -> int:
    """Shared memory of a ring of ``ring`` slots for each of n lines (and
    GROUP more: slot R repeats slot 0, slot R + 1 keeps rows 8-byte
    aligned)."""
    return 4 * n * (ring + GROUP)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def kernel_plan(delays: Tuple[int, ...], smem_limit: int) -> KernelPlan:
    """The kernel's launch for these delays on a card granting a block
    ``smem_limit`` bytes of shared memory.

    The ring variant takes steps of L = min(delay), capped at
    MAX_KERNEL_BLOCK and cut to a multiple of BALANCED_BLOCK (else of
    GROUP; L need not be a power of two), GROUP consecutive samples a
    thread (a thread takes several groups when there are more than
    MAX_THREADS), and a ring of R slots a line, the least power of two
    >= max(delay) + L.
    When :func:`ring_bytes` exceeds ``smem_limit``, or min(delay) < GROUP,
    the history goes to device memory (HIST: L = min(delay), capped, one
    sample at a time), else it is a ring in shared memory (RING). Above
    REGISTER_LINES lines the coefficients do not fit a thread's registers:
    LINES keeps them in shared memory and the history in device memory, one
    sample a thread, L = min(delay) capped at LINES_THREADS.
    """
    delays = tuple(int(d) for d in delays)
    n, m_min = len(delays), min(delays)
    if n > REGISTER_LINES:
        block = min(m_min, LINES_THREADS)
        return KernelPlan(LINES, block, _round_up(block, WARP), 0)
    cap = min(m_min, MAX_KERNEL_BLOCK)
    block = cap // BALANCED_BLOCK * BALANCED_BLOCK or cap // GROUP * GROUP
    ring = 1 << (max(delays) + block - 1).bit_length()
    if block == 0 or ring_bytes(n, ring) > smem_limit:
        return KernelPlan(HIST, cap, min(MAX_THREADS, _round_up(cap, WARP)), 0)
    threads = min(MAX_THREADS, _round_up(block // GROUP, WARP))
    return KernelPlan(RING, block, threads, ring)


def ring_boundary_delays(n: int, m_min: int, smem_limit: int, past: bool) -> Tuple[int, ...]:
    """N delays spread evenly from ``m_min`` up whose ring is the largest
    that fits ``smem_limit`` bytes (``past``: spread to a longest delay one
    sample more, which takes the device-memory history): the two sides of
    :func:`kernel_plan`'s choice, for the kernel's tests."""
    def spread(m_max):
        return tuple(int(d) for d in np.linspace(m_min, m_max, n))

    lo, hi = m_min, 1 << 30  # the ring fits at lo, not at hi
    if kernel_plan(spread(lo), smem_limit).variant != RING:
        raise ValueError(f"no ring of {n} lines from delay {m_min} fits {smem_limit} bytes")
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if kernel_plan(spread(mid), smem_limit).variant == RING else (lo, mid)
    return spread(hi if past else lo)


def shared_memory_limit(device: torch.device) -> int:
    """The shared memory (bytes) one block may take on this card."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _smem_limits:
        lib = _build.load("tdgfdn", _SIGNATURES)
        limit = lib.diffgfdn_tdgfdn_smem_limit(index)
        if limit < 0:
            raise RuntimeError(f"tdgfdn: cannot read the shared memory limit of cuda:{index}")
        _smem_limits[index] = limit
    return _smem_limits[index]


def _delay_index(delays: Tuple[int, ...], block: int, device):
    """(lines (1, N), columns (L, N)): ``hist[lines, columns + start]`` is the
    (L, N) block of the line-major history that samples start.. read, line i
    from ``hist[i, start + m_max - m_i ..]``."""
    m_max = max(delays)
    offsets = torch.tensor([m_max - d for d in delays], device=device)
    cols = offsets[None, :] + torch.arange(block, device=device)[:, None]
    return torch.arange(len(delays), device=device)[None, :], cols


def delay_line_outputs_plain(
    delays: Tuple[int, ...],
    gains: torch.Tensor,
    feedback_matrix: torch.Tensor,
    input_gains: torch.Tensor,
    input_signal: torch.Tensor,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`delay_line_outputs`: (T, N) float32.

    A Python loop over the T / L blocks: gather the delayed history, scale
    by the gains, mix, write the block into the history. The mix
    ``x_j = sum_i A[j][i] y_i`` is summed over i in ascending order, then
    ``b_j u`` is added, as the kernel sums it.
    """
    delays = tuple(int(d) for d in delays)
    n = len(delays)
    t_len = input_signal.shape[0]
    m_max = max(delays)
    L = _block_size(delays)
    n_blocks = -(-t_len // L)
    t_pad = n_blocks * L
    dev = input_signal.device

    u = torch.zeros(t_pad, dtype=torch.float32, device=dev)
    u[:t_len] = input_signal
    # line-major history: hist[i, m_max + t] = x_i[t], zero before t = 0
    hist = torch.zeros((n, t_pad + m_max), dtype=torch.float32, device=dev)
    lines, cols = _delay_index(delays, L, dev)
    a = feedback_matrix.to(torch.float32)
    g = gains.to(torch.float32)
    b = input_gains.to(torch.float32)
    y = torch.empty((t_pad, n), dtype=torch.float32, device=dev)
    for start in range(0, t_pad, L):
        y_blk = hist[lines, cols + start] * g  # (L, N)
        acc = y_blk[:, 0:1] * a[:, 0]
        for i in range(1, n):
            acc = acc + y_blk[:, i:i + 1] * a[:, i]
        x_blk = acc + u[start:start + L, None] * b
        hist[:, start + m_max:start + m_max + L] = x_blk.T
        y[start:start + L] = y_blk
    return y[:t_len]


def delay_line_outputs(
    delays: Tuple[int, ...],
    gains: torch.Tensor,
    feedback_matrix: torch.Tensor,
    input_gains: torch.Tensor,
    input_signal: torch.Tensor,
) -> torch.Tensor:
    """Delay-line outputs Y (T, N) float32 for an input signal.

    ``gains``: (N,) whole-delay absorption gains; ``feedback_matrix``:
    (N, N); ``input_gains``: (N,); ``input_signal``: (T,). CPU tensors take
    :func:`delay_line_outputs_plain`; CUDA tensors launch ``csrc/tdgfdn.cu``
    (any N <= 32, any delays >= 1; the variant of :func:`kernel_plan`),
    counted in ``delay_line_outputs.launches``; the kernel writes each
    line's samples contiguously (a warp's stores of a line are coalesced) and Y is
    the (T, N) transposed view of that (N, T) buffer.
    """
    delays = tuple(int(d) for d in delays)
    n = len(delays)
    if (gains.shape != (n,) or feedback_matrix.shape != (n, n) or input_gains.shape != (n,)
            or input_signal.dim() != 1):
        raise ValueError(
            f"delay_line_outputs takes N = {n} gains, an (N, N) feedback matrix, N input "
            f"gains and a (T,) signal; got {tuple(gains.shape)}, "
            f"{tuple(feedback_matrix.shape)}, {tuple(input_gains.shape)}, "
            f"{tuple(input_signal.shape)}"
        )
    if not runs_kernel(gains, feedback_matrix, input_gains, input_signal):
        return delay_line_outputs_plain(delays, gains, feedback_matrix, input_gains, input_signal)
    launch, y = kernel_launcher(delays, gains, feedback_matrix, input_gains, input_signal)
    launch()
    return y.T


delay_line_outputs.launches = 0


def kernel_launcher(
    delays: Tuple[int, ...],
    gains: torch.Tensor,
    feedback_matrix: torch.Tensor,
    input_gains: torch.Tensor,
    input_signal: torch.Tensor,
):
    """(launch, y): ``launch()`` runs ``csrc/tdgfdn.cu`` once on buffers
    prepared here (CUDA tensors; the plan of :func:`kernel_plan`) and
    writes y (N, T), a view of rows padded to a multiple of GROUP samples.
    Nothing is copied between host and card per launch: the delays travel
    in the kernel's parameters. Every launch counts in
    ``delay_line_outputs.launches``."""
    delays = tuple(int(d) for d in delays)
    n = len(delays)
    if n > MAX_N or min(delays) < 1:
        raise ValueError(f"tdgfdn kernel takes N <= {MAX_N} lines with delays >= 1")
    dev = input_signal.device
    plan = kernel_plan(delays, shared_memory_limit(dev))
    t_len = input_signal.shape[0]
    t_pad = _round_up(t_len, GROUP)  # u zero-padded, in a fresh aligned buffer
    u = torch.zeros(t_pad, dtype=torch.float32, device=dev)
    u[:t_len] = input_signal
    coef = torch.cat([feedback_matrix.reshape(-1), gains.reshape(-1),
                      input_gains.reshape(-1)]).to(torch.float32).contiguous()
    y = torch.empty((n, t_pad), dtype=torch.float32, device=dev)
    hist = (torch.empty((n, t_pad + max(delays)), dtype=torch.float32, device=dev)
            if plan.variant in (HIST, LINES) else y)
    host_delays = (ctypes.c_int * n)(*delays)
    lib = _build.load("tdgfdn", _SIGNATURES)

    def launch():
        with torch.cuda.device(dev):
            err = lib.diffgfdn_tdgfdn_f32(
                coef.data_ptr(), u.data_ptr(), y.data_ptr(), hist.data_ptr(), host_delays,
                t_pad, n, plan.block, plan.threads, plan.ring, plan.variant,
                torch.cuda.current_stream().cuda_stream,
            )
        _build.check(err, "delay_line_outputs")
        delay_line_outputs.launches += 1

    return launch, y[:, :t_len]


def time_domain_gfdn(
    delays: Tuple[int, ...],
    gains: torch.Tensor,
    feedback_matrix: torch.Tensor,
    input_gains: torch.Tensor,
    output_gains: torch.Tensor,
    input_signal: torch.Tensor,
    direct_gain: float = 0.0,
) -> torch.Tensor:
    """GFDN time-domain outputs (B, T) for a batch of output-gain vectors (B, N).

    The delay-line run is shared across the batch; the per-position mix is
    one matrix product.
    """
    y = delay_line_outputs(delays, gains, feedback_matrix, input_gains, input_signal)
    out = y @ output_gains.to(torch.float32).T  # (T, B)
    if direct_gain:
        out = out + direct_gain * input_signal[:, None]
    return out.T


def _impulse(num_samples: int, device) -> torch.Tensor:
    impulse = torch.zeros(num_samples, dtype=torch.float32, device=device)
    impulse[0] = 1.0
    return impulse


def synthesize_rirs_time_domain(
    delays: Tuple[int, ...],
    gains: torch.Tensor,
    feedback_matrix: torch.Tensor,
    input_gains: torch.Tensor,
    output_gains: torch.Tensor,
    num_samples: int,
) -> torch.Tensor:
    """Impulse-response synthesis: (B, num_samples) RIRs for B gain sets (B, N)."""
    impulse = _impulse(num_samples, output_gains.device)
    y = delay_line_outputs(delays, gains, feedback_matrix, input_gains, impulse)
    return (y @ output_gains.to(torch.float32).T).T


# ----------------- frequency-dependent absorption (exact) -------------------
#
# With an SOS/IIR absorption filter gamma_i(z) on every delay line the loop
# reads y_i[n] = (gamma_i * x_i)[n - m_i]: the filter acts on the DELAYED line
# signal, whose block is fully known history, so the block feedforward still
# applies. Within the filter, with (T, B, C, D) its state-space and s the
# state at block start,
#     y[n] = C T^n s  +  sum_{k<=n} h[n-k] u[k],        n = 0..L-1
#     s'   = T^L s    +  sum_k T^{L-1-k} B u[k]
# where h holds the filter's first L impulse-response samples: an exact
# linear convolution (a zero-padded rFFT product per block) plus the state's
# contribution. FILTER-mode coupling A(z) = sum_o A_o z^-o carries the last
# order - 1 samples of y across blocks.


class BlockFilterBank(NamedTuple):
    """Per-delay-line block state-space filter constants (host numpy f32).

    Shapes: ``h`` (N, L) first-L impulse response; ``p`` (N, L, m) initial-
    state response rows C T^n; ``q`` (N, m, L) input-to-state columns
    T^{L-1-k} B; ``tl`` (N, m, m) = T^L. ``m`` = state dimension.
    """

    h: np.ndarray
    p: np.ndarray
    q: np.ndarray
    tl: np.ndarray

    @property
    def block(self) -> int:
        return self.h.shape[1]


def sos_cascade_to_statespace(sos: np.ndarray):
    """(S, 3, 2) biquad cascade -> series state-space (T, B, C, D), float64.

    Per-section transposed direct-form II realization, composed in series.
    Section k is (b0 + b1 z^-1 + b2 z^-2) / (a0 + a1 z^-1 + a2 z^-2).
    """
    t = np.zeros((0, 0))
    bv = np.zeros(0)
    cv = np.zeros(0)
    d = 1.0
    for k in range(sos.shape[0]):
        b = np.asarray(sos[k, :, 0], np.float64)
        a = np.asarray(sos[k, :, 1], np.float64)
        b = b / a[0]
        a = a / a[0]
        a_k = np.array([[-a[1], 1.0], [-a[2], 0.0]])
        b_k = np.array([b[1] - a[1] * b[0], b[2] - a[2] * b[0]])
        c_k = np.array([1.0, 0.0])
        d_k = b[0]
        m_prev = t.shape[0]
        t = np.block(
            [
                [t, np.zeros((m_prev, 2))],
                [np.outer(b_k, cv).reshape(2, m_prev), a_k],
            ]
        )
        bv = np.concatenate([bv, b_k * d])
        cv = np.concatenate([d_k * cv, c_k])
        d = d_k * d
    return t, bv, cv, d


def iir_to_statespace(b: np.ndarray, a: np.ndarray):
    """Direct-form IIR (b, a) -> controllable-canonical (T, B, C, D), f64."""
    b = np.asarray(b, np.float64)
    a = np.asarray(a, np.float64)
    b = b / a[0]
    a = a / a[0]
    order = len(a) - 1
    b = np.concatenate([b, np.zeros(max(0, order + 1 - len(b)))])[: order + 1]
    t = np.zeros((order, order))
    t[0, :] = -a[1:]
    t[1:, :-1] = np.eye(order - 1)
    bv = np.zeros(order)
    bv[0] = 1.0
    cv = b[1:] - a[1:] * b[0]
    d = b[0]
    return t, bv, cv, d


def _block_constants(t, bv, cv, d, block: int):
    """(h, P, Q, T^L) block constants for one state-space filter, f64."""
    m = t.shape[0]
    p = np.zeros((block, m))
    q = np.zeros((m, block))
    tn = np.eye(m)
    for n in range(block):
        p[n] = cv @ tn  # C T^n
        q[:, block - 1 - n] = tn @ bv  # T^n B at column L-1-n
        tn = tn @ t
    h = np.zeros(block)
    h[0] = d
    if block > 1:
        h[1:] = p[: block - 1] @ bv  # C T^{j-1} B
    return h, p, q, tn  # tn == T^L


def _bank_from_statespaces(spaces, block: int) -> BlockFilterBank:
    hs, ps, qs, tls = [], [], [], []
    for t, bv, cv, d in spaces:
        h, p, q, tl = _block_constants(t, bv, cv, d, block)
        hs.append(h)
        ps.append(p)
        qs.append(q)
        tls.append(tl)
    return BlockFilterBank(
        h=np.stack(hs).astype(np.float32),
        p=np.stack(ps).astype(np.float32),
        q=np.stack(qs).astype(np.float32),
        tl=np.stack(tls).astype(np.float32),
    )


def filter_bank_from_sos(sos_coeffs: np.ndarray, delays: Tuple[int, ...]) -> BlockFilterBank:
    """Block filter bank from (N, S, 3, 2) absorption SOS cascades."""
    block = _block_size(delays)
    return _bank_from_statespaces(
        [sos_cascade_to_statespace(np.asarray(sos_coeffs[i]))
         for i in range(sos_coeffs.shape[0])],
        block,
    )


def filter_bank_from_iir(iir_coeffs: np.ndarray, delays: Tuple[int, ...]) -> BlockFilterBank:
    """Block filter bank from (N, order+1, 2) absorption IIR coefficients."""
    block = _block_size(delays)
    return _bank_from_statespaces(
        [iir_to_statespace(iir_coeffs[i, :, 0], iir_coeffs[i, :, 1])
         for i in range(iir_coeffs.shape[0])],
        block,
    )


def filter_bank_from_gains(gains: np.ndarray, delays: Tuple[int, ...]) -> BlockFilterBank:
    """Trivial (stateless) bank for scalar per-line gains — used to drive the
    filtered path with FILTER-mode coupling but broadband absorption."""
    block = _block_size(delays)
    spaces = [
        (np.zeros((1, 1)), np.zeros(1), np.zeros(1), float(g)) for g in gains
    ]
    return _bank_from_statespaces(spaces, block)


def delay_line_outputs_filtered(
    delays: Tuple[int, ...],
    filter_bank: BlockFilterBank,
    feedback: torch.Tensor,
    input_gains: torch.Tensor,
    input_signal: torch.Tensor,
) -> torch.Tensor:
    """Delay-line outputs Y (T, N) with per-line absorption FILTERS.

    ``feedback``: (N, N) static matrix, or (order, N, N) for FILTER-mode
    polynomial coupling A(z) = sum_o A_o z^-o. Exact (see the notes above).
    Runs on the input's device.
    """
    delays = tuple(int(d) for d in delays)
    n = len(delays)
    t_len = input_signal.shape[0]
    m_max = max(delays)
    L = filter_bank.block
    if L > min(delays):
        raise ValueError("filter bank block exceeds the minimum delay")
    n_blocks = -(-t_len // L)
    t_pad = n_blocks * L
    dev = input_signal.device

    u = torch.zeros(t_pad, dtype=torch.float32, device=dev)
    u[:t_len] = input_signal
    hist = torch.zeros((n, t_pad + m_max), dtype=torch.float32, device=dev)
    lines, cols = _delay_index(delays, L, dev)
    b = input_gains.to(torch.float32)
    poly = feedback.dim() == 3
    a_t = feedback.to(torch.float32).transpose(-1, -2)
    order = feedback.shape[0] if poly else 1

    const = {k: torch.as_tensor(getattr(filter_bank, k), device=dev) for k in ("h", "p", "q", "tl")}
    hf = torch.fft.rfft(const["h"], 2 * L, dim=-1).T  # (L+1, N)
    s = torch.zeros((n, const["p"].shape[-1]), dtype=torch.float32, device=dev)
    y_tail = torch.zeros((order - 1, n), dtype=torch.float32, device=dev)
    y = torch.empty((t_pad, n), dtype=torch.float32, device=dev)
    for start in range(0, t_pad, L):
        u_lines = hist[lines, cols + start]  # (L, N)
        # exact block filtering: within-block convolution + state response
        uf = torch.fft.rfft(u_lines, 2 * L, dim=0)  # (L+1, N)
        conv = torch.fft.irfft(uf * hf, 2 * L, dim=0)[:L]
        y_blk = conv + torch.einsum("nlm,nm->ln", const["p"], s)
        s = torch.einsum("nab,nb->na", const["tl"], s) + torch.einsum(
            "nml,ln->nm", const["q"], u_lines
        )
        x_blk = u[start:start + L, None] * b
        if poly:
            y_ext = torch.cat([y_tail, y_blk], dim=0)  # (L + order - 1, N)
            for o in range(order):
                x_blk = x_blk + y_ext[order - 1 - o:order - 1 - o + L] @ a_t[o]
            y_tail = y_ext[L:]
        else:
            x_blk = y_blk @ a_t + x_blk
        hist[:, start + m_max:start + m_max + L] = x_blk.T
        y[start:start + L] = y_blk
    return y[:t_len]


def synthesize_rirs_time_domain_filtered(
    delays: Tuple[int, ...],
    filter_bank: BlockFilterBank,
    feedback: torch.Tensor,
    input_gains: torch.Tensor,
    output_gains: torch.Tensor,
    num_samples: int,
    direct_gains: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Alias-free RIR synthesis with filtered absorption: (B, num_samples).

    The delay-line run is shared across the batch of output-gain vectors
    (B, N); the per-position mix is one matrix product.
    """
    impulse = _impulse(num_samples, output_gains.device)
    y = delay_line_outputs_filtered(delays, filter_bank, feedback, input_gains, impulse)
    out = (y @ output_gains.to(torch.float32).T).T
    if direct_gains is not None:
        out = out + direct_gains[:, None] * impulse[None, :]
    return out
