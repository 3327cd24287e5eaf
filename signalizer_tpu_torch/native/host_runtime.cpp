// signalizer_tpu native host runtime.
//
// C++ implementation of the host-side hot paths: the multichannel sample
// ring (cpl CLIFOStream / AudioStream history equivalent — the reference's
// runtime layer is native C++, so is ours), bulk frame gathering for the
// device batcher, and the mix-graph port gather. Exposed as a plain C ABI
// consumed from Python via ctypes (no pybind11 in the image).
//
// Concurrency contract (mirrors the Python RingBuffer): single writer,
// readers receive copies. A seqlock guards the sample data: the writer
// bumps an epoch around each mutation; readers retry their snapshot when
// the epoch moved underneath them (bounded retries — after that the
// possibly-mixed window is accepted rather than stalling a render
// thread; visualization data tolerates one frame of shear). Element
// accesses go through relaxed std::atomic_ref so the design is also
// formally race-free (ThreadSanitizer-clean; see native/stress_test.cpp).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

struct SzRing {
    int64_t channels;
    int64_t capacity;
    std::atomic<int64_t> head;         // next write index (writer-owned)
    std::atomic<int64_t> written;      // monotonic sample clock
    std::atomic<uint64_t> seq;         // seqlock epoch (odd = writing)
    std::vector<float> data;           // [channels][capacity]
};

static inline void relaxed_copy(float* dst, const float* src, int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
        std::atomic_ref<const float> a(src[i]);
        dst[i] = a.load(std::memory_order_relaxed);
    }
}

static inline void relaxed_store(float* dst, const float* src, int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
        std::atomic_ref<float> a(dst[i]);
        a.store(src[i], std::memory_order_relaxed);
    }
}

static inline void relaxed_fill(float* dst, float v, int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
        std::atomic_ref<float> a(dst[i]);
        a.store(v, std::memory_order_relaxed);
    }
}

SzRing* sz_ring_create(int64_t channels, int64_t capacity) {
    if (channels <= 0 || capacity <= 0) return nullptr;
    auto* r = new SzRing();
    r->channels = channels;
    r->capacity = capacity;
    r->head.store(0, std::memory_order_relaxed);
    r->written.store(0, std::memory_order_relaxed);
    r->seq.store(0, std::memory_order_relaxed);
    r->data.assign(static_cast<size_t>(channels * capacity), 0.0f);
    return r;
}

void sz_ring_destroy(SzRing* r) { delete r; }

int64_t sz_ring_clock(const SzRing* r) {
    return r->written.load(std::memory_order_acquire);
}

int64_t sz_ring_capacity(const SzRing* r) { return r->capacity; }

void sz_ring_clear(SzRing* r) {
    r->seq.fetch_add(1, std::memory_order_acq_rel);
    relaxed_fill(r->data.data(), 0.0f, static_cast<int64_t>(r->data.size()));
    r->head.store(0, std::memory_order_relaxed);
    r->written.store(0, std::memory_order_release);
    r->seq.fetch_add(1, std::memory_order_release);
}

// block: channel-major [channels][n] contiguous
void sz_ring_write(SzRing* r, const float* block, int64_t n) {
    if (n <= 0) return;
    const int64_t cap = r->capacity;
    r->seq.fetch_add(1, std::memory_order_acq_rel);  // odd: writing
    const int64_t head = r->head.load(std::memory_order_relaxed);
    if (n >= cap) {
        // keep only the trailing capacity samples
        for (int64_t c = 0; c < r->channels; ++c) {
            relaxed_store(&r->data[c * cap], block + c * n + (n - cap), cap);
        }
        r->head.store(0, std::memory_order_relaxed);
    } else {
        const int64_t first = std::min(n, cap - head);
        for (int64_t c = 0; c < r->channels; ++c) {
            relaxed_store(&r->data[c * cap + head], block + c * n, first);
            if (n - first > 0) {
                relaxed_store(&r->data[c * cap], block + c * n + first, n - first);
            }
        }
        r->head.store((head + n) % cap, std::memory_order_relaxed);
    }
    r->written.fetch_add(n, std::memory_order_release);
    r->seq.fetch_add(1, std::memory_order_release);  // even: stable
}

// Copy (op=0) or accumulate (op=1) one channel's window ending at
// absolute clock `end_clock` into dst[n]. Shared core of all reads.
static int read_channel(const SzRing* r, int64_t end_clock, int64_t channel,
                        float* dst, int64_t n, int op, int64_t written) {
    if (end_clock > written) return -2;
    const int64_t behind = written - end_clock;
    if (behind + n > r->capacity) return -1;
    const int64_t cap = r->capacity;
    const int64_t avail = std::min<int64_t>(n, std::min(written, cap) - behind);
    const int64_t pad = n - std::max<int64_t>(avail, 0);
    if (op == 0) std::memset(dst, 0, sizeof(float) * static_cast<size_t>(n));
    if (avail <= 0) return 0;
    int64_t start = (r->head.load(std::memory_order_relaxed) - behind - avail) % cap;
    if (start < 0) start += cap;
    const float* src = &r->data[channel * cap];
    const int64_t first = std::min(avail, cap - start);
    if (op == 0) {
        relaxed_copy(dst + pad, src + start, first);
        if (avail - first > 0)
            relaxed_copy(dst + pad + first, src, avail - first);
    } else {
        for (int64_t i = 0; i < first; ++i) {
            std::atomic_ref<const float> a(src[start + i]);
            dst[pad + i] += a.load(std::memory_order_relaxed);
        }
        for (int64_t i = 0; i < avail - first; ++i) {
            std::atomic_ref<const float> a(src[i]);
            dst[pad + first + i] += a.load(std::memory_order_relaxed);
        }
    }
    return 0;
}

// Seqlock-validated multi-channel snapshot: retries when the writer moved
// the epoch mid-copy; after kMaxRetries the (possibly sheared) window is
// accepted — visualization readers must never stall behind the writer.
static int read_window_consistent(const SzRing* r, int64_t end_clock,
                                  float* out, int64_t n, int use_latest) {
    constexpr int kMaxRetries = 8;
    int rc = 0;
    for (int attempt = 0; attempt < kMaxRetries; ++attempt) {
        const bool last = attempt == kMaxRetries - 1;
        const uint64_t s1 = r->seq.load(std::memory_order_acquire);
        // the final attempt copies even mid-write: a sheared window beats
        // returning nothing when the writer saturates the ring
        if ((s1 & 1) && !last) continue;
        const int64_t written = r->written.load(std::memory_order_acquire);
        const int64_t end = use_latest ? written : end_clock;
        rc = 0;
        for (int64_t c = 0; c < r->channels; ++c) {
            rc = read_channel(r, end, c, out + c * n, n, 0, written);
            if (rc != 0) break;
        }
        if (rc != 0) return rc;
        if (last) return 0;
        std::atomic_thread_fence(std::memory_order_acquire);
        if (r->seq.load(std::memory_order_relaxed) == s1) return 0;
    }
    return rc;
}

// Fill out [channels][n] with the window ending at absolute clock
// `end_clock`; zero-pads regions never written. Returns 0 on success,
// -1 if the window scrolled out of the ring, -2 if it lies in the future.
int sz_ring_read_at(const SzRing* r, int64_t end_clock, float* out, int64_t n) {
    return read_window_consistent(r, end_clock, out, n, 0);
}

int sz_ring_latest(const SzRing* r, float* out, int64_t n) {
    return read_window_consistent(r, 0, out, n, 1);
}

// Bulk frame extraction for the device batcher: frame k (k in
// [first_frame, first_frame+num_frames)) covers samples ending at
// round(k * hop) + window on the stream clock. out is
// [num_frames][channels][window]. Returns the number of frames actually
// written (frames that scrolled out are skipped, compacted to the front).
int64_t sz_frame_gather(const SzRing* r, int64_t first_frame, int64_t num_frames,
                        double hop, int64_t window, float* out) {
    int64_t emitted = 0;
    const int64_t stride = r->channels * window;
    for (int64_t k = first_frame; k < first_frame + num_frames; ++k) {
        const int64_t end_clock = static_cast<int64_t>(k * hop + 0.5) + window;
        if (sz_ring_read_at(r, end_clock, out + emitted * stride, window) == 0) {
            ++emitted;
        }
    }
    return emitted;
}

// Advance the monotonic clock to `clock`, zero-filling the gap (places a
// stream's ring on its own steady-clock timeline).
void sz_ring_seek(SzRing* r, int64_t clock) {
    const int64_t written = r->written.load(std::memory_order_relaxed);
    if (clock <= written) return;
    r->seq.fetch_add(1, std::memory_order_acq_rel);
    const int64_t gap = clock - written;
    const int64_t head = r->head.load(std::memory_order_relaxed);
    if (gap >= r->capacity) {
        relaxed_fill(r->data.data(), 0.0f, static_cast<int64_t>(r->data.size()));
        r->head.store(0, std::memory_order_relaxed);
        r->written.store(clock, std::memory_order_release);
        r->seq.fetch_add(1, std::memory_order_release);
        return;
    }
    // zero-fill the gap in ring space
    for (int64_t c = 0; c < r->channels; ++c) {
        int64_t pos = head;
        for (int64_t i = 0; i < gap; ++i) {
            std::atomic_ref<float> a(r->data[c * r->capacity + pos]);
            a.store(0.0f, std::memory_order_relaxed);
            pos = (pos + 1) % r->capacity;
        }
    }
    r->head.store((head + gap) % r->capacity, std::memory_order_relaxed);
    r->written.fetch_add(gap, std::memory_order_release);
    r->seq.fetch_add(1, std::memory_order_release);
}

// Mix gather: accumulate one channel of a source ring at end_clock into a
// destination row (the mix graph's port gather). Out-of-range channels
// contribute silence (returns -3) — never an out-of-bounds read.
int sz_mix_accumulate(const SzRing* r, int64_t end_clock, int64_t src_channel,
                      float* dst_row, int64_t n) {
    if (src_channel < 0 || src_channel >= r->channels) return -3;
    const int64_t written = r->written.load(std::memory_order_acquire);
    return read_channel(r, end_clock, src_channel, dst_row, n, 1, written);
}

// ---------------------------------------------------------------------------
// Blocking lock-free SPSC packet queue — the readerwriterqueue /
// cpl::CLockFreeDataQueue analogue feeding the threaded AudioStream's
// consumer thread (ref: SURVEY.md §2.9 LockFreeDataQueue / §2.8
// readerwriterqueue). Single producer (the real-time audio thread), single
// consumer (the delivery thread). Pushes are wait-free and allocation-free
// (slots preallocated); pops block on a POSIX semaphore (the
// BlockingReaderWriterQueue pattern: lock-free ring + counting semaphore).
// ---------------------------------------------------------------------------

}  // extern "C"

#include <cerrno>
#include <semaphore.h>
#include <time.h>

extern "C" {

struct SzPacketQueue {
    int64_t capacity;     // packet slots
    int64_t channels;
    int64_t max_samples;  // samples per slot
    std::atomic<int64_t> head{0};   // producer-owned write counter
    std::atomic<int64_t> tail{0};   // consumer-owned read counter
    std::atomic<int64_t> dropped{0};
    std::atomic<bool> alive{true};
    sem_t items;                    // filled-slot count (blocking pop)
    std::vector<float> audio;       // [capacity][channels][max_samples]
    std::vector<int64_t> meta_i;    // [capacity][6]: n, position, steady, playing, clock, gen
    std::vector<double> meta_d;     // [capacity]: bpm
};

SzPacketQueue* sz_pq_create(int64_t channels, int64_t max_samples, int64_t capacity) {
    if (channels <= 0 || max_samples <= 0 || capacity <= 0) return nullptr;
    auto* q = new SzPacketQueue();
    q->capacity = capacity;
    q->channels = channels;
    q->max_samples = max_samples;
    q->audio.assign(static_cast<size_t>(capacity * channels * max_samples), 0.0f);
    q->meta_i.assign(static_cast<size_t>(capacity * 6), 0);
    q->meta_d.assign(static_cast<size_t>(capacity), 0.0);
    sem_init(&q->items, 0, 0);
    return q;
}

void sz_pq_destroy(SzPacketQueue* q) {
    if (!q) return;
    sem_destroy(&q->items);
    delete q;
}

int64_t sz_pq_size(const SzPacketQueue* q) {
    return q->head.load(std::memory_order_acquire) -
           q->tail.load(std::memory_order_acquire);
}

int64_t sz_pq_dropped(const SzPacketQueue* q) {
    return q->dropped.load(std::memory_order_relaxed);
}

// Producer: copy one packet in. Returns 0, or -1 when full (packet dropped,
// counted) — the real-time thread never blocks.
int sz_pq_push(SzPacketQueue* q, const float* block, int64_t n,
               int64_t position, int64_t steady, double bpm, int64_t playing,
               int64_t end_clock, int64_t generation) {
    if (n <= 0 || n > q->max_samples) return -2;
    const int64_t head = q->head.load(std::memory_order_relaxed);
    const int64_t tail = q->tail.load(std::memory_order_acquire);
    if (head - tail >= q->capacity) {
        q->dropped.fetch_add(1, std::memory_order_relaxed);
        return -1;
    }
    const int64_t slot = head % q->capacity;
    float* dst = q->audio.data() + slot * q->channels * q->max_samples;
    for (int64_t c = 0; c < q->channels; ++c) {
        std::memcpy(dst + c * q->max_samples, block + c * n,
                    static_cast<size_t>(n) * sizeof(float));
    }
    int64_t* mi = q->meta_i.data() + slot * 6;
    mi[0] = n; mi[1] = position; mi[2] = steady; mi[3] = playing;
    mi[4] = end_clock; mi[5] = generation;
    q->meta_d[static_cast<size_t>(slot)] = bpm;
    q->head.store(head + 1, std::memory_order_release);
    sem_post(&q->items);
    return 0;
}

// Consumer: blocking pop with timeout. out must hold channels*max_samples
// floats (written channel-major with stride max_samples); meta_out[6] gets
// {n, position, steady, playing, end_clock, generation}; bpm_out the tempo.
// Returns 0 ok, -1 timeout, -2 closed-and-drained.
int sz_pq_pop(SzPacketQueue* q, float* out, int64_t* meta_out, double* bpm_out,
              int64_t timeout_ms) {
    // CLOCK_MONOTONIC deadline: a wall-clock step (NTP/admin) must not
    // stretch or truncate the consumer's wait; retry on EINTR so a signal
    // is not misreported as a timeout.
    struct timespec ts;
#if defined(__GLIBC__) && ((__GLIBC__ > 2) || (__GLIBC__ == 2 && __GLIBC_MINOR__ >= 30))
    clock_gettime(CLOCK_MONOTONIC, &ts);
    ts.tv_sec += timeout_ms / 1000;
    ts.tv_nsec += (timeout_ms % 1000) * 1000000L;
    if (ts.tv_nsec >= 1000000000L) { ts.tv_sec += 1; ts.tv_nsec -= 1000000000L; }
    int rc;
    while ((rc = sem_clockwait(&q->items, CLOCK_MONOTONIC, &ts)) != 0 &&
           errno == EINTR) {}
#else
    clock_gettime(CLOCK_REALTIME, &ts);
    ts.tv_sec += timeout_ms / 1000;
    ts.tv_nsec += (timeout_ms % 1000) * 1000000L;
    if (ts.tv_nsec >= 1000000000L) { ts.tv_sec += 1; ts.tv_nsec -= 1000000000L; }
    int rc;
    while ((rc = sem_timedwait(&q->items, &ts)) != 0 && errno == EINTR) {}
#endif
    if (rc != 0) {
        return q->alive.load(std::memory_order_acquire) ? -1 : -2;
    }
    const int64_t tail = q->tail.load(std::memory_order_relaxed);
    if (tail == q->head.load(std::memory_order_acquire)) {
        // woken by close() with nothing queued
        return -2;
    }
    const int64_t slot = tail % q->capacity;
    const float* src = q->audio.data() + slot * q->channels * q->max_samples;
    std::memcpy(out, src,
                static_cast<size_t>(q->channels * q->max_samples) * sizeof(float));
    const int64_t* mi = q->meta_i.data() + slot * 6;
    for (int k = 0; k < 6; ++k) meta_out[k] = mi[k];
    *bpm_out = q->meta_d[static_cast<size_t>(slot)];
    q->tail.store(tail + 1, std::memory_order_release);
    return 0;
}

// Close: mark dead and wake the consumer so it can observe the drained state.
void sz_pq_close(SzPacketQueue* q) {
    q->alive.store(false, std::memory_order_release);
    sem_post(&q->items);
}

}  // extern "C"
