// ltefrontend: native host-side IQ frontend for the LTE sensing framework.
//
// Equivalent of the reference's native GNU Radio runtime pieces
// (file_source / ring buffers / rational_resampler_ccc — SURVEY §2.2b):
// everything that happens to samples BEFORE they board the device.  Hot
// paths are plain -O3 C++ the compiler auto-vectorizes:
//
//   * interleaved complex64 -> planar float32 re/im (the device-side layout;
//     see ltetrigger_jax/ops/cplx.py)
//   * integer polyphase decimation on the host: decimating 30.72 -> 1.92
//     Msps before transfer cuts host->device traffic 16x
//   * a lock-free SPSC ring buffer for live streaming producers (SDR
//     processes, sockets) feeding the Python driver
//
// Exposed as a C ABI consumed via ctypes (ltetrigger_jax/runtime/native.py).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// deinterleave: [n] interleaved (re, im) float32 -> two planar arrays
// ---------------------------------------------------------------------------
void lf_deinterleave(const float* interleaved, int64_t n, float* re,
                     float* im) {
  for (int64_t i = 0; i < n; ++i) {
    re[i] = interleaved[2 * i];
    im[i] = interleaved[2 * i + 1];
  }
}

// ---------------------------------------------------------------------------
// polyphase decimator (complex in, planar out)
//
// y[k] = sum_j h[j] * x[k * ratio - lead + j], matching the framework's
// refrx.decimate / ops.resample alignment (symmetric taps, mirrored pad).
// Polyphase form: split h by phase so each output sample touches each input
// exactly once.
// ---------------------------------------------------------------------------
struct lf_decimator {
  int ratio;
  int ntaps;
  int lead;  // (ntaps-1)/2 group-delay compensation
  std::vector<float> taps;
  // streaming state: tail of the previous chunk (ntaps-1 complex samples)
  std::vector<float> hist;  // interleaved, 2*(ntaps-1)
  int64_t in_count = 0;     // total samples consumed (for phase continuity)
};

lf_decimator* lf_decimator_create(int ratio, const float* taps, int ntaps) {
  auto* d = new lf_decimator();
  d->ratio = ratio;
  d->ntaps = ntaps;
  d->lead = ntaps - 1 - (ntaps - 1) / 2;  // pad-front amount (see resample.py)
  d->taps.assign(taps, taps + ntaps);
  d->hist.assign(2 * (ntaps - 1), 0.0f);
  return d;
}

void lf_decimator_destroy(lf_decimator* d) { delete d; }

// One-shot decimation of a full buffer (no streaming state).
// in: interleaved complex float32 [n]; out: interleaved complex float32
// [ceil(n/ratio)].  Returns number of output complex samples.
int64_t lf_decimate(const lf_decimator* d, const float* in, int64_t n,
                    float* out) {
  const int ratio = d->ratio, ntaps = d->ntaps;
  const int64_t n_out = (n + ratio - 1) / ratio;
  const float* h = d->taps.data();
  for (int64_t k = 0; k < n_out; ++k) {
    // y[k] = sum_j h[j] x[k*ratio - lead + j]
    const int64_t base = k * ratio - d->lead;
    int64_t j0 = base < 0 ? -base : 0;
    int64_t j1 = ntaps;
    if (base + j1 > n) j1 = n - base;
    float acc_re = 0.f, acc_im = 0.f;
    const float* xp = in + 2 * (base + j0);
    for (int64_t j = j0; j < j1; ++j) {
      const float c = h[j];
      acc_re += c * xp[0];
      acc_im += c * xp[1];
      xp += 2;
    }
    out[2 * k] = acc_re;
    out[2 * k + 1] = acc_im;
  }
  return n_out;
}

// ---------------------------------------------------------------------------
// SPSC lock-free ring buffer of complex64 samples
// ---------------------------------------------------------------------------
struct lf_ring {
  std::vector<float> data;  // interleaved, 2*capacity floats
  int64_t capacity;
  std::atomic<int64_t> head{0};  // write index (samples)
  std::atomic<int64_t> tail{0};  // read index (samples)
};

lf_ring* lf_ring_create(int64_t capacity) {
  auto* r = new lf_ring();
  r->capacity = capacity;
  r->data.assign(2 * capacity, 0.0f);
  return r;
}

void lf_ring_destroy(lf_ring* r) { delete r; }

int64_t lf_ring_capacity(const lf_ring* r) { return r->capacity; }

int64_t lf_ring_available(const lf_ring* r) {
  return r->head.load(std::memory_order_acquire) -
         r->tail.load(std::memory_order_acquire);
}

// producer: append up to n samples; returns number actually written
int64_t lf_ring_write(lf_ring* r, const float* interleaved, int64_t n) {
  const int64_t head = r->head.load(std::memory_order_relaxed);
  const int64_t tail = r->tail.load(std::memory_order_acquire);
  const int64_t space = r->capacity - (head - tail);
  if (n > space) n = space;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t slot = (head + i) % r->capacity;
    r->data[2 * slot] = interleaved[2 * i];
    r->data[2 * slot + 1] = interleaved[2 * i + 1];
  }
  r->head.store(head + n, std::memory_order_release);
  return n;
}

// consumer: pop up to n samples into out; returns count
int64_t lf_ring_read(lf_ring* r, float* out, int64_t n) {
  const int64_t tail = r->tail.load(std::memory_order_relaxed);
  const int64_t head = r->head.load(std::memory_order_acquire);
  int64_t avail = head - tail;
  if (n > avail) n = avail;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t slot = (tail + i) % r->capacity;
    out[2 * i] = r->data[2 * slot];
    out[2 * i + 1] = r->data[2 * slot + 1];
  }
  r->tail.store(tail + n, std::memory_order_release);
  return n;
}

// ---------------------------------------------------------------------------
// file source: load a raw complex64 capture, optional looping reader
// ---------------------------------------------------------------------------
struct lf_filesource {
  std::vector<float> data;  // interleaved
  int64_t n_samples = 0;
  int64_t pos = 0;
  int repeat = 0;
};

lf_filesource* lf_filesource_open(const char* path, int repeat) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  const long bytes = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  auto* s = new lf_filesource();
  s->n_samples = bytes / 8;  // complex64
  s->data.resize(2 * s->n_samples);
  const size_t got = std::fread(s->data.data(), 8, s->n_samples, f);
  std::fclose(f);
  if ((int64_t)got != s->n_samples) {
    delete s;
    return nullptr;
  }
  s->repeat = repeat;
  return s;
}

void lf_filesource_close(lf_filesource* s) { delete s; }

int64_t lf_filesource_len(const lf_filesource* s) { return s->n_samples; }

// read up to n complex samples (looping if repeat); returns count (0 = EOF)
int64_t lf_filesource_read(lf_filesource* s, float* out, int64_t n) {
  int64_t written = 0;
  while (written < n) {
    if (s->pos >= s->n_samples) {
      if (!s->repeat) break;
      s->pos = 0;
    }
    const int64_t chunk =
        std::min(n - written, s->n_samples - s->pos);
    std::memcpy(out + 2 * written, s->data.data() + 2 * s->pos,
                (size_t)chunk * 8);
    s->pos += chunk;
    written += chunk;
  }
  return written;
}

}  // extern "C"
