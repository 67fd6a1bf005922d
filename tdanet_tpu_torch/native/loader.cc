// tdanet_tpu_torch native batch loader (the JAX package's
// tdanet_tpu/native/loader.cc, kept draw for draw).
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
// chunk), so long files cost O(segment) IO.
//
// The audio-visual variant also reads each source's mouth crops from the
// "data.npy" entry of an .npz (a ZIP archive: the central directory, stored
// and deflate entries through zlib, zip64 sizes, each entry's CRC-32
// checked) as float32 (fps_len, h, w)
// frames, truncated or zero-padded on the frame axis. An archive that
// cannot be read fails its batch: next() returns -1 and
// tdanet_loader_error() names the file.

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <unistd.h>
#include <vector>
#include <zlib.h>

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

// ---------------------------------------------------------------------
// .npz (ZIP) + .npy reading for the audio-visual mouth branch
// ---------------------------------------------------------------------

uint16_t rd16(const uint8_t* p) { uint16_t v; memcpy(&v, p, 2); return v; }
uint32_t rd32(const uint8_t* p) { uint32_t v; memcpy(&v, p, 4); return v; }
uint64_t rd64(const uint8_t* p) { uint64_t v; memcpy(&v, p, 8); return v; }

// Extract one entry by walking the central directory (numpy's zipfile
// streams entries, so local headers may carry zero sizes; only the central
// directory is reliable). Handles stored (0) and deflate (8), plus the
// zip64 extra field for sizes and offsets marked 0xFFFFFFFF.
bool read_zip_entry(int fd, int64_t file_size, const std::string& want,
                    std::vector<uint8_t>* out) {
  int64_t tail = file_size < 66000 ? file_size : 66000;
  if (tail < 22) return false;
  std::vector<uint8_t> buf(tail);
  if (pread(fd, buf.data(), tail, file_size - tail) != tail) return false;
  int64_t eocd = -1;
  for (int64_t i = tail - 22; i >= 0; --i) {
    if (rd32(&buf[i]) == 0x06054b50) { eocd = i; break; }
  }
  if (eocd < 0) return false;
  uint64_t n_entries = rd16(&buf[eocd + 10]);
  uint64_t cd_off = rd32(&buf[eocd + 16]);
  if (cd_off == 0xFFFFFFFFu || n_entries == 0xFFFFu) {
    // zip64: its locator sits 20 bytes before the end record
    if (eocd < 20 || rd32(&buf[eocd - 20]) != 0x07064b50) return false;
    uint64_t z64_off = rd64(&buf[eocd - 20 + 8]);
    uint8_t z64[56];
    if (pread(fd, z64, 56, z64_off) != 56 ||
        rd32(z64) != 0x06064b50) return false;
    n_entries = rd64(z64 + 32);
    cd_off = rd64(z64 + 48);
  }
  int64_t off = cd_off;
  for (uint64_t e = 0; e < n_entries; ++e) {
    uint8_t h[46];
    if (pread(fd, h, 46, off) != 46 || rd32(h) != 0x02014b50) return false;
    uint16_t method = rd16(h + 10);
    uint32_t crc = rd32(h + 16);
    uint64_t csize = rd32(h + 20), usize = rd32(h + 24);
    uint16_t nlen = rd16(h + 28), elen = rd16(h + 30), clen = rd16(h + 32);
    uint64_t lho = rd32(h + 42);
    std::string name(nlen, '\0');
    if (pread(fd, name.data(), nlen, off + 46) != nlen) return false;
    if (csize == 0xFFFFFFFFu || usize == 0xFFFFFFFFu ||
        lho == 0xFFFFFFFFu) {
      std::vector<uint8_t> extra(elen);
      if (pread(fd, extra.data(), elen, off + 46 + nlen) != elen)
        return false;
      for (size_t i = 0; i + 4 <= extra.size();) {
        uint16_t id = rd16(&extra[i]), sz = rd16(&extra[i + 2]);
        if (id == 0x0001) {
          size_t p = i + 4, end = std::min(i + 4 + sz, extra.size());
          auto next = [&](uint64_t* v) {
            if (*v != 0xFFFFFFFFu) return true;
            if (p + 8 > end) return false;
            *v = rd64(&extra[p]);
            p += 8;
            return true;
          };
          if (!next(&usize) || !next(&csize) || !next(&lho)) return false;
          break;
        }
        i += 4 + sz;
      }
    }
    if (name == want) {
      // The sizes are checked before anything is allocated from them: a
      // stored entry's two sizes agree, and deflate expands at most 1032:1.
      if (csize > (uint64_t)file_size) return false;
      if (method == 0 ? usize != csize
                      : method == 8 ? usize > 1032 * csize + 64 : true)
        return false;
      uint8_t lh[30];
      if (pread(fd, lh, 30, lho) != 30 || rd32(lh) != 0x04034b50)
        return false;
      int64_t data_off = lho + 30 + rd16(lh + 26) + rd16(lh + 28);
      if (data_off + (int64_t)csize > file_size) return false;
      std::vector<uint8_t> comp(csize);
      if (pread(fd, comp.data(), csize, data_off) != (int64_t)csize)
        return false;
      out->resize(usize);
      if (method == 0) {
        memcpy(out->data(), comp.data(), usize);
      } else if (method == 8) {
        z_stream zs;
        memset(&zs, 0, sizeof(zs));
        if (inflateInit2(&zs, -15) != Z_OK) return false;  // raw deflate
        zs.next_in = comp.data();
        zs.avail_in = csize;
        zs.next_out = out->data();
        zs.avail_out = usize;
        int rc = inflate(&zs, Z_FINISH);
        inflateEnd(&zs);
        if (rc != Z_STREAM_END || zs.total_out != usize) return false;
      } else {
        return false;
      }
      // the entry's CRC-32: a garbled archive can still inflate
      return crc32(0L, out->data(), usize) == crc;
    }
    off += 46 + nlen + elen + clen;
  }
  return false;
}

struct NpyArray {
  std::vector<int64_t> shape;
  char kind = '?';         // 'f' float, 'u' uint, 'i' int
  int itemsize = 0;
  int64_t data_start = 0;  // byte offset of the raw data in the buffer
};

bool parse_npy_header(const std::vector<uint8_t>& b, NpyArray* a) {
  if (b.size() < 10 || memcmp(b.data(), "\x93NUMPY", 6) != 0) return false;
  int major = b[6];
  uint32_t hlen;
  int64_t hoff;
  if (major == 1) { hlen = rd16(&b[8]); hoff = 10; }
  else if (b.size() >= 12) { hlen = rd32(&b[8]); hoff = 12; }
  else return false;
  if ((int64_t)b.size() < hoff + (int64_t)hlen) return false;
  std::string h(reinterpret_cast<const char*>(&b[hoff]), hlen);
  a->data_start = hoff + hlen;
  if (h.find("'fortran_order': False") == std::string::npos) return false;
  size_t d = h.find("'descr':");
  if (d == std::string::npos) return false;
  size_t q1 = h.find('\'', d + 8), q2 = h.find('\'', q1 + 1);
  if (q1 == std::string::npos || q2 == std::string::npos) return false;
  std::string descr = h.substr(q1 + 1, q2 - q1 - 1);  // e.g. <f4, |u1
  if (descr.size() < 3) return false;
  if (descr[0] == '>') return false;  // big-endian unsupported
  a->kind = descr[1];
  a->itemsize = atoi(descr.c_str() + 2);
  size_t s = h.find("'shape':");
  if (s == std::string::npos) return false;
  size_t p1 = h.find('(', s), p2 = h.find(')', p1);
  if (p1 == std::string::npos || p2 == std::string::npos) return false;
  std::string dims = h.substr(p1 + 1, p2 - p1 - 1);
  a->shape.clear();
  const char* c = dims.c_str();
  while (*c) {
    while (*c == ' ' || *c == ',') ++c;
    if (!*c) break;
    a->shape.push_back(strtoll(c, const_cast<char**>(&c), 10));
  }
  return true;
}

// Read npz[entry] as float32 frames of h*w elements into out[fps_len, h, w],
// truncating or zero-padding the frame axis (the dataset's mouths[:,
// :fps_len], padded to the batch's shape).
bool read_npz_mouth(const std::string& path, const std::string& entry,
                    int64_t fps_len, int64_t mh, int64_t mw, float* out) {
  int fd = open(path.c_str(), O_RDONLY);
  if (fd < 0) return false;
  int64_t fsize = lseek(fd, 0, SEEK_END);
  std::vector<uint8_t> raw;
  bool ok = read_zip_entry(fd, fsize, entry, &raw);
  close(fd);
  NpyArray a;
  if (!ok || !parse_npy_header(raw, &a) || a.shape.size() != 3 ||
      a.shape[1] != mh || a.shape[2] != mw)
    return false;
  int64_t frame = mh * mw;
  int64_t n = a.shape[0] < fps_len ? a.shape[0] : fps_len;
  const uint8_t* data = raw.data() + a.data_start;
  if ((int64_t)raw.size() - a.data_start < a.shape[0] * frame * a.itemsize)
    return false;
  if (a.kind == 'f' && a.itemsize == 4) {
    memcpy(out, data, n * frame * 4);
  } else if (a.kind == 'f' && a.itemsize == 8) {
    const double* s = reinterpret_cast<const double*>(data);
    for (int64_t i = 0; i < n * frame; ++i) out[i] = (float)s[i];
  } else if (a.kind == 'u' && a.itemsize == 1) {
    for (int64_t i = 0; i < n * frame; ++i) out[i] = (float)data[i];
  } else {
    return false;
  }
  for (int64_t i = n * frame; i < fps_len * frame; ++i) out[i] = 0.0f;
  return true;
}

struct Batch {
  std::vector<float> mix;    // B * T
  std::vector<float> src;    // B * n_src * T
  std::vector<float> mouth;  // B * n_src * fps_len * mh * mw (AV only)
  std::string error;         // the archive that could not be read
};

class Loader {
 public:
  Loader(std::vector<std::string> mix_paths,
         std::vector<std::string> src_paths,  // item-major, n_src each
         std::vector<int64_t> lengths, int n_src, int64_t seg_len,
         int batch_size, bool shuffle, uint64_t seed, int num_threads,
         int prefetch,
         std::vector<std::string> mouth_paths = {},  // item-major, n_src
         int64_t fps_len = 0, int64_t mh = 0, int64_t mw = 0)
      : mix_paths_(std::move(mix_paths)), src_paths_(std::move(src_paths)),
        mouth_paths_(std::move(mouth_paths)), lengths_(std::move(lengths)),
        n_src_(n_src), seg_(seg_len), fps_len_(fps_len), mh_(mh), mw_(mw),
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

  // Returns 1 on success, 0 at epoch end, -1 when the batch failed
  // (error() names the file).
  int next(float* mix_out, float* src_out, float* mouth_out = nullptr) {
    std::unique_lock<std::mutex> lk(m_);
    if (next_batch_to_emit_ >= n_batches_) return 0;
    int64_t want = next_batch_to_emit_;
    cv_.wait(lk, [&] { return done_[want] != nullptr || stopping_; });
    if (stopping_) return 0;
    Batch* b = done_[want];
    if (!b->error.empty()) {
      error_ = b->error;
      return -1;
    }
    memcpy(mix_out, b->mix.data(), b->mix.size() * sizeof(float));
    memcpy(src_out, b->src.data(), b->src.size() * sizeof(float));
    if (mouth_out != nullptr)
      memcpy(mouth_out, b->mouth.data(), b->mouth.size() * sizeof(float));
    delete b;
    done_[want] = nullptr;
    ++next_batch_to_emit_;
    cv_space_.notify_all();
    return 1;
  }

  int64_t n_batches() const { return n_batches_; }

  const char* error() const { return error_.c_str(); }

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
      int64_t mouth_item = fps_len_ * mh_ * mw_;
      if (mouth_item > 0) b->mouth.resize(bs_ * n_src_ * mouth_item);
      std::mt19937_64 item_rng(seed_ + epoch_ * 1000003ULL + bi);
      for (int k = 0; k < bs_; ++k) {
        size_t item = order_[bi * bs_ + k];
        int64_t len = lengths_[item];
        int64_t start = 0;
        if (len > seg_) start = item_rng() % (len - seg_);
        read_wav_segment(mix_paths_[item], start, seg_,
                         b->mix.data() + k * seg_);
        for (int s = 0; s < n_src_; ++s) {
          read_wav_segment(src_paths_[item * n_src_ + s], start, seg_,
                           b->src.data() + (k * n_src_ + s) * seg_);
          const std::string& mouth = mouth_item > 0
              ? mouth_paths_[item * n_src_ + s] : std::string();
          if (mouth_item > 0 && b->error.empty() &&
              !read_npz_mouth(mouth, "data.npy", fps_len_, mh_, mw_,
                              b->mouth.data() +
                                  (k * n_src_ + s) * mouth_item))
            b->error = mouth;
        }
      }
      {
        std::lock_guard<std::mutex> lk(m_);
        done_[bi] = b;
      }
      cv_.notify_all();
    }
  }

  std::vector<std::string> mix_paths_, src_paths_, mouth_paths_;
  std::vector<int64_t> lengths_;
  int n_src_;
  int64_t seg_, fps_len_ = 0, mh_ = 0, mw_ = 0;
  std::string error_;
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

const char* tdanet_loader_error(void* h) {
  return static_cast<Loader*>(h)->error();
}

// Audio-visual variant: mouth_paths is item-major with n_src .npz paths
// per item; each batch also yields (B, n_src, fps_len, mh, mw) float32
// mouth crops.
void* tdanet_loader_create_av(const char** mix_paths,
                              const char** src_paths,
                              const char** mouth_paths,
                              const int64_t* lengths, int64_t n_items,
                              int n_src, int64_t seg_len, int batch_size,
                              int shuffle, uint64_t seed, int num_threads,
                              int prefetch, int64_t fps_len, int64_t mh,
                              int64_t mw) {
  std::vector<std::string> mix(mix_paths, mix_paths + n_items);
  std::vector<std::string> src(src_paths, src_paths + n_items * n_src);
  std::vector<std::string> mouth(mouth_paths,
                                 mouth_paths + n_items * n_src);
  std::vector<int64_t> lens(lengths, lengths + n_items);
  return new Loader(std::move(mix), std::move(src), std::move(lens), n_src,
                    seg_len, batch_size, shuffle != 0, seed, num_threads,
                    prefetch, std::move(mouth), fps_len, mh, mw);
}

int tdanet_loader_next_av(void* h, float* mix_out, float* src_out,
                          float* mouth_out) {
  return static_cast<Loader*>(h)->next(mix_out, src_out, mouth_out);
}

// The (frames, h, w) of an .npz's "data" array; returns 0 on failure.
int tdanet_npz_mouth_dims(const char* path, int64_t* dims3) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return 0;
  int64_t fsize = lseek(fd, 0, SEEK_END);
  std::vector<uint8_t> raw;
  bool ok = read_zip_entry(fd, fsize, "data.npy", &raw);
  close(fd);
  NpyArray a;
  if (!ok || !parse_npy_header(raw, &a) || a.shape.size() != 3) return 0;
  dims3[0] = a.shape[0];
  dims3[1] = a.shape[1];
  dims3[2] = a.shape[2];
  return 1;
}

}  // extern "C"
