// Native multithreaded WAV batch loader.
//
// The training datasets read 7 microphone WAVs (plus GT tracks) per sample
// at 48 kHz.  This loader decodes 16/24/32-bit PCM and float WAVs straight
// into a caller-provided float32 buffer, fanning file IO + decode out over
// a worker pool.  A copy of the JAX package's runtime/wavloader.cpp, built
// with g++ and bound through ctypes by runtime/native.py of the PyTorch
// port, which has no fallback reader.
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct WavInfo {
  uint16_t format = 0;     // 1 = PCM, 3 = float
  uint16_t channels = 0;
  uint32_t sample_rate = 0;
  uint16_t bits = 0;
  const uint8_t* data = nullptr;
  size_t data_len = 0;
};

// Parse RIFF chunks in an in-memory file image.
bool parse_wav(const uint8_t* buf, size_t len, WavInfo* info) {
  if (len < 12 || memcmp(buf, "RIFF", 4) != 0 || memcmp(buf + 8, "WAVE", 4) != 0)
    return false;
  size_t pos = 12;
  bool have_fmt = false;
  while (pos + 8 <= len) {
    const uint8_t* cid = buf + pos;
    uint32_t csize;
    memcpy(&csize, buf + pos + 4, 4);
    pos += 8;
    if (pos + csize > len) csize = static_cast<uint32_t>(len - pos);
    if (memcmp(cid, "fmt ", 4) == 0 && csize >= 16) {
      memcpy(&info->format, buf + pos, 2);
      memcpy(&info->channels, buf + pos + 2, 2);
      memcpy(&info->sample_rate, buf + pos + 4, 4);
      memcpy(&info->bits, buf + pos + 14, 2);
      if (info->format == 0xFFFE && csize >= 26)  // extensible
        memcpy(&info->format, buf + pos + 24, 2);
      have_fmt = true;
    } else if (memcmp(cid, "data", 4) == 0) {
      info->data = buf + pos;
      info->data_len = csize;
    }
    pos += csize + (csize & 1);
  }
  return have_fmt && info->data != nullptr;
}

// Decode samples into out[0..max_samples) (mono or first channel), return
// number of frames written.
int64_t decode(const WavInfo& info, float* out, int64_t max_frames) {
  const int ch = info.channels;
  int64_t frames = 0;
  if (info.format == 3 && info.bits == 32) {
    const float* s = reinterpret_cast<const float*>(info.data);
    int64_t total = static_cast<int64_t>(info.data_len / 4 / ch);
    frames = total < max_frames ? total : max_frames;
    for (int64_t i = 0; i < frames; ++i) out[i] = s[i * ch];
  } else if (info.format == 1 && info.bits == 16) {
    const int16_t* s = reinterpret_cast<const int16_t*>(info.data);
    int64_t total = static_cast<int64_t>(info.data_len / 2 / ch);
    frames = total < max_frames ? total : max_frames;
    const float k = 1.0f / 32768.0f;
    for (int64_t i = 0; i < frames; ++i) out[i] = s[i * ch] * k;
  } else if (info.format == 1 && info.bits == 32) {
    const int32_t* s = reinterpret_cast<const int32_t*>(info.data);
    int64_t total = static_cast<int64_t>(info.data_len / 4 / ch);
    frames = total < max_frames ? total : max_frames;
    const float k = 1.0f / 2147483648.0f;
    for (int64_t i = 0; i < frames; ++i) out[i] = s[i * ch] * k;
  } else if (info.format == 1 && info.bits == 24) {
    const uint8_t* s = info.data;
    int64_t total = static_cast<int64_t>(info.data_len / 3 / ch);
    frames = total < max_frames ? total : max_frames;
    const float k = 1.0f / 8388608.0f;
    for (int64_t i = 0; i < frames; ++i) {
      const uint8_t* p = s + static_cast<size_t>(i) * 3 * ch;
      int32_t v = (p[0] | (p[1] << 8) | (p[2] << 16)) << 8;
      out[i] = (v >> 8) * k;
    }
  } else {
    return -1;
  }
  return frames;
}

int64_t load_one(const char* path, float* out, int64_t max_frames,
                 int* sample_rate) {
  FILE* f = fopen(path, "rb");
  if (!f) return -2;
  fseek(f, 0, SEEK_END);
  long flen = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(static_cast<size_t>(flen));
  size_t got = fread(buf.data(), 1, buf.size(), f);
  fclose(f);
  if (got != buf.size()) return -3;

  WavInfo info;
  if (!parse_wav(buf.data(), buf.size(), &info)) return -4;
  if (sample_rate) *sample_rate = static_cast<int>(info.sample_rate);
  return decode(info, out, max_frames);
}

}  // namespace

extern "C" {

// Decode one WAV's first channel into out (float32). Returns frames written
// or a negative error code.
int64_t swarm_load_wav(const char* path, float* out, int64_t max_frames,
                       int* sample_rate) {
  return load_one(path, out, max_frames, sample_rate);
}

// Decode n WAVs in parallel into a contiguous (n, max_frames) float32
// buffer, zero-padding shorter files.  frames_out[i] receives the decoded
// frame count (or negative error). Returns 0 on success.
int swarm_load_wavs(const char** paths, int n, float* out, int64_t max_frames,
                    int64_t* frames_out, int n_threads) {
  if (n_threads <= 0) n_threads = 4;
  std::atomic<int> next(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      float* dst = out + static_cast<int64_t>(i) * max_frames;
      memset(dst, 0, sizeof(float) * static_cast<size_t>(max_frames));
      frames_out[i] = load_one(paths[i], dst, max_frames, nullptr);
    }
  };
  std::vector<std::thread> pool;
  int spawn = n_threads < n ? n_threads : n;
  for (int t = 0; t < spawn; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return 0;
}

}  // extern "C"
