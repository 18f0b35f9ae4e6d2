// Asynchronous binary trajectory writer.
//
// The reference has no persistence at all (no checkpoint or resume); this
// is the native half of the framework's trajectory /
// streaming-checkpoint subsystem: frames are enqueued by the simulation
// driver (host copies only) and flushed to disk by a background thread, so
// disk latency never blocks the device step loop.
//
// Backpressure: the pending queue is bounded by bytes (kMaxPendingBytes).
// When disk falls behind, sphsm_traj_append BLOCKS until space frees —
// bounded host memory at multi-million-particle frame sizes beats an
// unbounded deque that OOMs the run.
//
// File format "SPHT0001": header {magic[8], int64 n_particles,
// int64 fields_per_particle}, then frames of
// {int64 step, float payload[n_particles * fields_per_particle]}.
//
// Plain C ABI for ctypes. The PyTorch port keeps its own copy of the JAX
// package's source (same ABI and format); runtime/__init__.py builds it.

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

namespace {

constexpr int64_t kMaxPendingBytes = 256ll << 20;  // 256 MB

struct Frame {
    int64_t step;
    std::vector<float> payload;
};

struct Writer {
    FILE* f = nullptr;
    int64_t n = 0;
    int64_t fields = 0;
    std::deque<Frame> queue;
    int64_t queue_bytes = 0;
    std::mutex mu;
    std::condition_variable cv;        // producer -> worker: data ready
    std::condition_variable cv_space;  // worker -> producer: space freed
    std::thread worker;
    bool closing = false;
    bool write_error = false;          // set on short fwrite (disk full/IO)
    int64_t frames_written = 0;

    void run() {
        for (;;) {
            Frame fr;
            {
                std::unique_lock<std::mutex> lk(mu);
                cv.wait(lk, [&] { return closing || !queue.empty(); });
                if (queue.empty()) {
                    if (closing) return;
                    continue;
                }
                fr = std::move(queue.front());
                queue.pop_front();
                queue_bytes -=
                    static_cast<int64_t>(fr.payload.size() * sizeof(float));
            }
            cv_space.notify_one();
            if (!write_error) {
                size_t a = std::fwrite(&fr.step, sizeof(int64_t), 1, f);
                size_t b = std::fwrite(fr.payload.data(), sizeof(float),
                                       fr.payload.size(), f);
                if (a != 1 || b != fr.payload.size()) {
                    write_error = true;  // stop writing; surface via close
                } else {
                    ++frames_written;
                }
            }
        }
    }
};

}  // namespace

extern "C" {

void* sphsm_traj_open(const char* path, int64_t n_particles,
                      int64_t fields_per_particle) {
    FILE* f = std::fopen(path, "wb");
    if (!f) return nullptr;
    auto* w = new Writer();
    w->f = f;
    w->n = n_particles;
    w->fields = fields_per_particle;
    const char magic[8] = {'S', 'P', 'H', 'T', '0', '0', '0', '1'};
    std::fwrite(magic, 1, 8, f);
    std::fwrite(&w->n, sizeof(int64_t), 1, f);
    std::fwrite(&w->fields, sizeof(int64_t), 1, f);
    w->worker = std::thread([w] { w->run(); });
    return w;
}

// Enqueue one frame (copies the payload; returns pending queue depth).
// Blocks while the queue holds >= kMaxPendingBytes of pending payload so a
// slow disk throttles the producer instead of exhausting host memory.
int64_t sphsm_traj_append(void* handle, int64_t step, const float* payload) {
    auto* w = static_cast<Writer*>(handle);
    Frame fr;
    fr.step = step;
    fr.payload.assign(payload, payload + w->n * w->fields);
    const int64_t bytes =
        static_cast<int64_t>(fr.payload.size() * sizeof(float));
    std::unique_lock<std::mutex> lk(w->mu);
    w->cv_space.wait(lk, [&] {
        return w->closing || w->queue.empty()
               || w->queue_bytes + bytes <= kMaxPendingBytes;
    });
    w->queue.push_back(std::move(fr));
    w->queue_bytes += bytes;
    int64_t depth = static_cast<int64_t>(w->queue.size());
    lk.unlock();
    w->cv.notify_one();
    return depth;
}

// Flush + close; returns frames written, or -(frames_written + 1) if a
// disk write error occurred (the file is truncated at the last good frame).
int64_t sphsm_traj_close(void* handle) {
    auto* w = static_cast<Writer*>(handle);
    {
        std::unique_lock<std::mutex> lk(w->mu);
        w->closing = true;
    }
    w->cv.notify_one();
    w->cv_space.notify_all();
    w->worker.join();
    std::fclose(w->f);
    int64_t result = w->write_error ? -(w->frames_written + 1)
                                    : w->frames_written;
    delete w;
    return result;
}

}  // extern "C"
