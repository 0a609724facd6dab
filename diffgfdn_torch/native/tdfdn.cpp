// Sample-exact GFDN time-domain processor (native streaming renderer).
//
// The port's block recursion (diffgfdn_torch/kernels/tdgfdn.py, kernel B7 on
// the card) owns batch synthesis; this C++ processor is the host-side
// real-time audio path: stateful streaming with per-callback block
// processing, no device dependency. Built as a shared library with g++,
// bound via ctypes (diffgfdn_torch/native/tdfdn.py).
//
// Model (matches the frequency-sampled transfer function, see
// models/feedback_loop.py): per line i with delay m_i and absorption
// gamma_i (a scalar gain OR an SOS biquad cascade), the delay-line output
// is y_i[t] = (gamma_i * x_i)[t - m_i];
// x[t] = A y[t] + b u[t]; output_j[t] = c_j . y[t] + d * u[t].
//
// Frequency-dependent decay: tdfdn_set_absorption_sos installs per-line
// biquad cascades (the GEQ fits from ops/absorption.py), run in transposed
// direct-form II — the same realization the block recursion's state-space
// composition uses (kernels/tdgfdn.py sos_cascade_to_statespace), so both
// paths are sample-exact against each other.

#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct TDFDN {
    int n = 0;
    std::vector<int> delays;
    std::vector<float> gains;   // whole-delay absorption gains
    std::vector<float> a;       // n x n feedback matrix, row major
    std::vector<float> b;       // input gains
    std::vector<std::vector<float>> ring;  // per-line ring buffers
    std::vector<int> pos;       // ring write/read cursor per line
    std::vector<float> y;       // scratch: current delay-line outputs
    // optional per-line SOS absorption: n x n_sections x 6 (b0 b1 b2 a0 a1
    // a2, normalized so a0 == 1 at install time) + n x n_sections x 2 state
    int n_sections = 0;
    std::vector<float> sos;
    std::vector<float> sos_state;
};

inline float run_cascade(TDFDN* f, int line, float x) {
    const int s = f->n_sections;
    float* coeff = f->sos.data() + (size_t)line * s * 6;
    float* state = f->sos_state.data() + (size_t)line * s * 2;
    for (int k = 0; k < s; ++k, coeff += 6, state += 2) {
        // transposed direct-form II biquad
        const float y = coeff[0] * x + state[0];
        state[0] = coeff[1] * x - coeff[4] * y + state[1];
        state[1] = coeff[2] * x - coeff[5] * y;
        x = y;
    }
    return x;
}

}  // namespace

extern "C" {

TDFDN* tdfdn_create(int n, const int* delays, const float* gains,
                    const float* a, const float* b) {
    TDFDN* f = new TDFDN();
    f->n = n;
    f->delays.assign(delays, delays + n);
    f->gains.assign(gains, gains + n);
    f->a.assign(a, a + n * n);
    f->b.assign(b, b + n);
    f->ring.resize(n);
    f->pos.assign(n, 0);
    for (int i = 0; i < n; ++i) f->ring[i].assign(delays[i], 0.0f);
    f->y.assign(n, 0.0f);
    return f;
}

void tdfdn_destroy(TDFDN* f) { delete f; }

void tdfdn_reset(TDFDN* f) {
    for (int i = 0; i < f->n; ++i)
        std::fill(f->ring[i].begin(), f->ring[i].end(), 0.0f);
    std::fill(f->pos.begin(), f->pos.end(), 0);
    std::fill(f->sos_state.begin(), f->sos_state.end(), 0.0f);
}

// Install per-line SOS absorption cascades, replacing the scalar gains.
//   sos: n x n_sections x 6 coefficients (b0 b1 b2 a0 a1 a2), row major.
void tdfdn_set_absorption_sos(TDFDN* f, const float* sos, int n_sections) {
    f->n_sections = n_sections;
    f->sos.assign(sos, sos + (size_t)f->n * n_sections * 6);
    // normalize each section by its a0 once, so the hot loop skips it
    for (size_t k = 0; k < f->sos.size(); k += 6) {
        const float a0 = f->sos[k + 3];
        for (int j = 0; j < 6; ++j) f->sos[k + j] /= a0;
    }
    f->sos_state.assign((size_t)f->n * n_sections * 2, 0.0f);
}

// Process n_samples through the FDN for n_outs simultaneous output taps.
//   in:   n_samples input samples
//   c:    n_outs x n output-gain matrix (row major)
//   out:  n_outs x n_samples output buffer (row major), OVERWRITTEN
//   direct: direct-path gain added to every output
void tdfdn_process(TDFDN* f, const float* in, long n_samples, const float* c,
                   int n_outs, float direct, float* out) {
    const int n = f->n;
    const bool filtered = f->n_sections > 0;
    for (long t = 0; t < n_samples; ++t) {
        // read delayed, absorbed line outputs
        if (filtered) {
            for (int i = 0; i < n; ++i)
                f->y[i] = run_cascade(f, i, f->ring[i][f->pos[i]]);
        } else {
            for (int i = 0; i < n; ++i)
                f->y[i] = f->gains[i] * f->ring[i][f->pos[i]];
        }
        const float u = in[t];
        // outputs: C y + d u
        for (int j = 0; j < n_outs; ++j) {
            const float* cj = c + (size_t)j * n;
            float acc = direct * u;
            for (int i = 0; i < n; ++i) acc += cj[i] * f->y[i];
            out[(size_t)j * n_samples + t] = acc;
        }
        // feedback: x = A y + b u, written into the ring buffers
        for (int i = 0; i < n; ++i) {
            const float* ai = f->a.data() + (size_t)i * n;
            float acc = f->b[i] * u;
            for (int k = 0; k < n; ++k) acc += ai[k] * f->y[k];
            f->ring[i][f->pos[i]] = acc;
            f->pos[i] = (f->pos[i] + 1) % f->delays[i];
        }
    }
}

}  // extern "C"
