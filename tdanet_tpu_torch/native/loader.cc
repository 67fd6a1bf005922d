// tdanet_tpu_torch native batch loader (the audio path of the JAX
// package's tdanet_tpu/native/loader.cc, kept draw for draw).
//
// A C++ thread pool decodes mono WAV files (PCM16 / float32), random-crops
// training segments, assembles fixed-shape (batch, T) mixture and
// (batch, n_src, T) source arrays and hands them to Python through a
// bounded queue, over a plain C ABI (ctypes; datas/native_loader.py).
//
// The draws: an epoch's order is a Fisher-Yates shuffle driven by
// std::mt19937_64(seed + epoch); batch b's crop starts come, item by item,
// from std::mt19937_64(seed + epoch * 1000003 + b), start = draw %
// (length - segment) where the manifest length exceeds the segment, else
// 0. datas/native_loader.py repeats them in Python.
//
// Only the cropped byte range of each wav is read (pread on the data
// chunk), so long files cost O(segment) IO. The audio-visual .npz reader
// of the JAX package's loader is not here: the port reads audio only.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct WavInfo {
  int64_t data_offset = 0;   // byte offset of sample data
  int64_t n_frames = 0;
  int16_t format = 1;        // 1 = PCM16, 3 = float32
  int16_t channels = 1;
  int16_t bytes_per_sample = 2;
};

bool parse_wav_header(int fd, WavInfo* info) {
  uint8_t hdr[12];
  if (pread(fd, hdr, 12, 0) != 12) return false;
  if (memcmp(hdr, "RIFF", 4) != 0 || memcmp(hdr + 8, "WAVE", 4) != 0)
    return false;
  int64_t off = 12;
  uint8_t chunk[8];
  bool have_fmt = false;
  while (pread(fd, chunk, 8, off) == 8) {
    uint32_t size;
    memcpy(&size, chunk + 4, 4);
    if (memcmp(chunk, "fmt ", 4) == 0) {
      uint8_t fmt[16];
      if (pread(fd, fmt, 16, off + 8) != 16) return false;
      memcpy(&info->format, fmt, 2);
      memcpy(&info->channels, fmt + 2, 2);
      int16_t bits;
      memcpy(&bits, fmt + 14, 2);
      info->bytes_per_sample = bits / 8;
      have_fmt = true;
    } else if (memcmp(chunk, "data", 4) == 0) {
      info->data_offset = off + 8;
      if (!have_fmt) return false;
      info->n_frames =
          size / (info->bytes_per_sample * info->channels);
      return true;
    }
    off += 8 + size + (size & 1);
  }
  return false;
}

// Read [start, start+count) mono frames as float32 into out, the frames
// past the file's end as zeros.
bool read_wav_segment(const std::string& path, int64_t start, int64_t count,
                      float* out) {
  int fd = open(path.c_str(), O_RDONLY);
  if (fd < 0) return false;
  WavInfo info;
  if (!parse_wav_header(fd, &info) || info.channels != 1) {
    close(fd);
    return false;
  }
  int64_t avail = info.n_frames - start;
  int64_t n = count < avail ? count : (avail > 0 ? avail : 0);
  int64_t nbytes = n * info.bytes_per_sample;
  std::vector<uint8_t> buf(nbytes);
  int64_t got = pread(fd, buf.data(), nbytes,
                      info.data_offset + start * info.bytes_per_sample);
  close(fd);
  if (got != nbytes) return false;
  if (info.format == 3 && info.bytes_per_sample == 4) {
    memcpy(out, buf.data(), n * 4);
  } else if (info.format == 1 && info.bytes_per_sample == 2) {
    const int16_t* s = reinterpret_cast<const int16_t*>(buf.data());
    for (int64_t i = 0; i < n; ++i) out[i] = s[i] / 32768.0f;
  } else {
    return false;
  }
  for (int64_t i = n; i < count; ++i) out[i] = 0.0f;  // zero-pad tail
  return true;
}

struct Batch {
  std::vector<float> mix;    // B * T
  std::vector<float> src;    // B * n_src * T
};

class Loader {
 public:
  Loader(std::vector<std::string> mix_paths,
         std::vector<std::string> src_paths,  // item-major, n_src each
         std::vector<int64_t> lengths, int n_src, int64_t seg_len,
         int batch_size, bool shuffle, uint64_t seed, int num_threads,
         int prefetch)
      : mix_paths_(std::move(mix_paths)), src_paths_(std::move(src_paths)),
        lengths_(std::move(lengths)), n_src_(n_src), seg_(seg_len),
        bs_(batch_size), shuffle_(shuffle), seed_(seed),
        prefetch_(prefetch) {
    n_threads_ = num_threads > 0 ? num_threads : 2;
    start_epoch(0);
  }

  ~Loader() { stop(); }

  void start_epoch(uint64_t epoch) {
    stop();
    order_.resize(mix_paths_.size());
    for (size_t i = 0; i < order_.size(); ++i) order_[i] = i;
    if (shuffle_) {
      std::mt19937_64 rng(seed_ + epoch);
      for (size_t i = order_.size(); i > 1; --i) {
        size_t j = rng() % i;
        std::swap(order_[i - 1], order_[j]);
      }
    }
    epoch_ = epoch;
    next_batch_to_build_.store(0);
    next_batch_to_emit_ = 0;
    n_batches_ = static_cast<int64_t>(order_.size()) / bs_;  // drop_last
    done_.assign(n_batches_, nullptr);
    stopping_ = false;
    for (int t = 0; t < n_threads_; ++t)
      workers_.emplace_back([this] { work(); });
  }

  // Returns 1 on success, 0 at epoch end.
  int next(float* mix_out, float* src_out) {
    std::unique_lock<std::mutex> lk(m_);
    if (next_batch_to_emit_ >= n_batches_) return 0;
    int64_t want = next_batch_to_emit_;
    cv_.wait(lk, [&] { return done_[want] != nullptr || stopping_; });
    if (stopping_) return 0;
    Batch* b = done_[want];
    memcpy(mix_out, b->mix.data(), b->mix.size() * sizeof(float));
    memcpy(src_out, b->src.data(), b->src.size() * sizeof(float));
    delete b;
    done_[want] = nullptr;
    ++next_batch_to_emit_;
    cv_space_.notify_all();
    return 1;
  }

  int64_t n_batches() const { return n_batches_; }

 private:
  void stop() {
    {
      std::lock_guard<std::mutex> lk(m_);
      stopping_ = true;
    }
    cv_.notify_all();
    cv_space_.notify_all();
    for (auto& w : workers_) w.join();
    workers_.clear();
    for (auto*& b : done_) {
      delete b;
      b = nullptr;
    }
  }

  void work() {
    while (true) {
      int64_t bi = next_batch_to_build_.fetch_add(1);
      if (bi >= n_batches_) return;
      // backpressure: keep at most `prefetch_` batches ahead
      {
        std::unique_lock<std::mutex> lk(m_);
        cv_space_.wait(lk, [&] {
          return stopping_ || bi < next_batch_to_emit_ + prefetch_;
        });
        if (stopping_) return;
      }
      auto* b = new Batch;
      b->mix.resize(bs_ * seg_);
      b->src.resize(bs_ * n_src_ * seg_);
      std::mt19937_64 item_rng(seed_ + epoch_ * 1000003ULL + bi);
      for (int k = 0; k < bs_; ++k) {
        size_t item = order_[bi * bs_ + k];
        int64_t len = lengths_[item];
        int64_t start = 0;
        if (len > seg_) start = item_rng() % (len - seg_);
        read_wav_segment(mix_paths_[item], start, seg_,
                         b->mix.data() + k * seg_);
        for (int s = 0; s < n_src_; ++s)
          read_wav_segment(src_paths_[item * n_src_ + s], start, seg_,
                           b->src.data() + (k * n_src_ + s) * seg_);
      }
      {
        std::lock_guard<std::mutex> lk(m_);
        done_[bi] = b;
      }
      cv_.notify_all();
    }
  }

  std::vector<std::string> mix_paths_, src_paths_;
  std::vector<int64_t> lengths_;
  int n_src_;
  int64_t seg_;
  int bs_;
  bool shuffle_;
  uint64_t seed_, epoch_ = 0;
  int prefetch_, n_threads_;
  std::vector<size_t> order_;
  std::vector<std::thread> workers_;
  std::vector<Batch*> done_;
  std::atomic<int64_t> next_batch_to_build_{0};
  int64_t next_batch_to_emit_ = 0;
  int64_t n_batches_ = 0;
  bool stopping_ = false;
  std::mutex m_;
  std::condition_variable cv_, cv_space_;
};

}  // namespace

extern "C" {

void* tdanet_loader_create(const char** mix_paths, const char** src_paths,
                           const int64_t* lengths, int64_t n_items,
                           int n_src, int64_t seg_len, int batch_size,
                           int shuffle, uint64_t seed, int num_threads,
                           int prefetch) {
  std::vector<std::string> mix(mix_paths, mix_paths + n_items);
  std::vector<std::string> src(src_paths, src_paths + n_items * n_src);
  std::vector<int64_t> lens(lengths, lengths + n_items);
  return new Loader(std::move(mix), std::move(src), std::move(lens), n_src,
                    seg_len, batch_size, shuffle != 0, seed, num_threads,
                    prefetch);
}

int tdanet_loader_next(void* h, float* mix_out, float* src_out) {
  return static_cast<Loader*>(h)->next(mix_out, src_out);
}

int64_t tdanet_loader_n_batches(void* h) {
  return static_cast<Loader*>(h)->n_batches();
}

void tdanet_loader_start_epoch(void* h, uint64_t epoch) {
  static_cast<Loader*>(h)->start_epoch(epoch);
}

void tdanet_loader_destroy(void* h) { delete static_cast<Loader*>(h); }

}  // extern "C"
