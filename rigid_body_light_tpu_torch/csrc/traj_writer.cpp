// Asynchronous binary trajectory writer of rigid_body_light_tpu_torch — the
// port's own copy of rigid_body_light_tpu/runtime/traj_writer.cpp, the same
// file format byte for byte.  Production BD runs need frame logging that
// never blocks the device loop: the writer queues frames into a bounded
// queue and writes them from a dedicated thread; the simulation thread's
// append is a memcpy.  Built with the host's g++ at first use
// (runtime/trajectory.py).
//
// File format (little endian):
//   header: magic "RBLT" | u32 version | u32 n_bodies | u32 dtype(0=f32,1=f64)
//           | u32 reserved[3]
//   frame:  u64 step | f64 sim_time | X[n*3] | Q[n*4]   (dtype elements)
//
// Plain C interface for the ctypes binding.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0x544C4252;  // "RBLT"
constexpr uint32_t kVersion = 1;

struct Frame {
  uint64_t step;
  double sim_time;
  std::vector<uint8_t> payload;  // X then Q, raw dtype bytes
};

class TrajWriter {
 public:
  TrajWriter(const char* path, uint32_t n_bodies, uint32_t dtype,
             uint32_t queue_capacity, uint32_t append)
      : n_bodies_(n_bodies),
        dtype_(dtype),
        capacity_(queue_capacity ? queue_capacity : 64),
        stop_(false),
        error_(false) {
    file_ = std::fopen(path, append ? "ab" : "wb");
    if (!file_) {
      error_ = true;
      return;
    }
    if (!append) {
      uint32_t header[8] = {kMagic, kVersion, n_bodies, dtype, 0, 0, 0, 0};
      if (std::fwrite(header, sizeof(header), 1, file_) != 1) {
        error_ = true;
        std::fclose(file_);
        file_ = nullptr;
        return;
      }
    }
    worker_ = std::thread([this] { this->Run(); });
  }

  ~TrajWriter() { Close(); }

  bool Append(uint64_t step, double sim_time, const void* x, const void* q) {
    if (error_) return false;
    size_t item = dtype_ == 1 ? 8 : 4;
    size_t nx = static_cast<size_t>(n_bodies_) * 3 * item;
    size_t nq = static_cast<size_t>(n_bodies_) * 4 * item;
    Frame f;
    f.step = step;
    f.sim_time = sim_time;
    f.payload.resize(nx + nq);
    std::memcpy(f.payload.data(), x, nx);
    std::memcpy(f.payload.data() + nx, q, nq);
    {
      std::unique_lock<std::mutex> lock(mu_);
      // bounded queue: block (briefly) if the disk cannot keep up, rather
      // than growing without limit
      not_full_.wait(lock, [this] { return queue_.size() < capacity_ || stop_; });
      if (stop_) return false;
      queue_.push(std::move(f));
    }
    not_empty_.notify_one();
    return true;
  }

  void Flush() {
    std::unique_lock<std::mutex> lock(mu_);
    // a frame is "in flight" between the worker's pop and its fwrite —
    // drain only when the queue is empty AND nothing is being written
    drained_.wait(lock, [this] { return (queue_.empty() && !writing_) || error_; });
    if (file_) std::fflush(file_);
  }

  void Close() {
    {
      std::unique_lock<std::mutex> lock(mu_);
      if (stop_) return;
      stop_ = true;
    }
    not_empty_.notify_all();
    not_full_.notify_all();
    if (worker_.joinable()) worker_.join();
    if (file_) {
      std::fflush(file_);
      std::fclose(file_);
      file_ = nullptr;
    }
  }

  bool ok() const { return !error_; }
  uint64_t frames_written() const { return frames_written_.load(); }

 private:
  void Run() {
    for (;;) {
      Frame f;
      {
        std::unique_lock<std::mutex> lock(mu_);
        not_empty_.wait(lock, [this] { return !queue_.empty() || stop_; });
        if (queue_.empty()) {
          if (stop_) return;
          continue;
        }
        f = std::move(queue_.front());
        queue_.pop();
        writing_ = true;
      }
      not_full_.notify_one();
      bool ok = std::fwrite(&f.step, sizeof(f.step), 1, file_) == 1 &&
                std::fwrite(&f.sim_time, sizeof(f.sim_time), 1, file_) == 1 &&
                std::fwrite(f.payload.data(), f.payload.size(), 1, file_) == 1;
      if (!ok) error_ = true;
      frames_written_.fetch_add(1);
      {
        std::unique_lock<std::mutex> lock(mu_);
        writing_ = false;
        if (queue_.empty()) drained_.notify_all();
      }
    }
  }

  FILE* file_ = nullptr;
  uint32_t n_bodies_;
  uint32_t dtype_;
  size_t capacity_;
  std::mutex mu_;
  std::condition_variable not_empty_, not_full_, drained_;
  std::queue<Frame> queue_;
  std::thread worker_;
  std::atomic<bool> stop_;
  std::atomic<bool> error_;
  bool writing_ = false;  // guarded by mu_
  std::atomic<uint64_t> frames_written_{0};
};

}  // namespace

extern "C" {

void* rblt_tw_open(const char* path, uint32_t n_bodies, uint32_t dtype,
                   uint32_t queue_capacity, uint32_t append) {
  auto* w = new TrajWriter(path, n_bodies, dtype, queue_capacity, append);
  if (!w->ok()) {
    delete w;
    return nullptr;
  }
  return w;
}

int rblt_tw_append(void* handle, uint64_t step, double sim_time, const void* x,
                   const void* q) {
  return static_cast<TrajWriter*>(handle)->Append(step, sim_time, x, q) ? 0 : 1;
}

void rblt_tw_flush(void* handle) { static_cast<TrajWriter*>(handle)->Flush(); }

uint64_t rblt_tw_frames(void* handle) {
  return static_cast<TrajWriter*>(handle)->frames_written();
}

void rblt_tw_close(void* handle) {
  auto* w = static_cast<TrajWriter*>(handle);
  w->Close();
  delete w;
}

}  // extern "C"
