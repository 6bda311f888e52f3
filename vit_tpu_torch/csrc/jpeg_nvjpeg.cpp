// Batch JPEG decode on nvJPEG + host bilinear resize: the port's decoder where
// native/jpeg_decoder.cpp cannot build (a machine without libjpeg's headers,
// such as the H100 machine, whose CUDA toolkit ships nvJPEG).
//
// It replaces no TPU kernel: it is the card machine's way to the host decode
// that vit_tpu/data.py does with libjpeg. It exports the same C ABI as
// native/jpeg_decoder.cpp (vt_api_version, vt_decode_jpeg_batch with its
// per-image status array and thread count), plus vt_nvjpeg_init, so that
// vit_tpu_torch/data.py binds both with one ctypes signature, and it returns
// the same uint8 [n, out_size, out_size, 3] RGB batch on the host after the
// same half-pixel bilinear resize.
//
// Each host thread takes a worker (an nvJPEG decode state, a non-blocking
// stream, a device image and a pinned host buffer) from a pool that lives as
// long as the process: nvJPEG parses the Huffman data on the host thread, runs
// the IDCT and colour conversion on the card, and the worker copies the image
// back and resizes it on the host. Buffers only grow, and are kept, because
// cudaFree would wait for the whole device, and so for the model's forward.
// Non-blocking streams keep the decode from serialising with work on the
// legacy default stream.
//
// Numbers differ from libjpeg's: nvJPEG's IDCT and chroma upsampling are its
// own, so the decode is held to libjpeg's within a stated tolerance
// (chip_smoke.JPEG_TOL), not bit for bit. The _FLAG_DCT_SCALE flag is taken
// and ignored: nvJPEG decodes at full scale.
//
// Build: vit_tpu_torch/ops/_build.py build_nvjpeg (nvcc ... -lnvjpeg).

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct Worker {
  nvjpegJpegState_t state = nullptr;
  cudaStream_t stream = nullptr;
  unsigned char* dev = nullptr;
  size_t dev_bytes = 0;
  unsigned char* host = nullptr;
  size_t host_bytes = 0;
};

constexpr size_t kMinBuffer = size_t(8) << 20;  // a 1024 x 768 RGB image is 2.4 MB

std::mutex g_mu;
nvjpegHandle_t g_handle = nullptr;
int g_init = -1;  // -1: not tried; 0: ready; else the failure's code
std::vector<Worker*> g_free;

Worker* acquire() {
  std::lock_guard<std::mutex> lock(g_mu);
  if (!g_free.empty()) {
    Worker* w = g_free.back();
    g_free.pop_back();
    return w;
  }
  Worker* w = new Worker();
  if (nvjpegJpegStateCreate(g_handle, &w->state) != NVJPEG_STATUS_SUCCESS ||
      cudaStreamCreateWithFlags(&w->stream, cudaStreamNonBlocking) != cudaSuccess) {
    delete w;  // leaks a half-made state rather than free it under a busy device
    return nullptr;
  }
  return w;
}

void release(Worker* w) {
  std::lock_guard<std::mutex> lock(g_mu);
  g_free.push_back(w);
}

bool grow_device(Worker* w, size_t bytes) {
  if (bytes <= w->dev_bytes) return true;
  if (w->dev != nullptr) cudaFree(w->dev);
  w->dev_bytes = std::max(bytes, kMinBuffer);
  if (cudaMalloc(&w->dev, w->dev_bytes) != cudaSuccess) {
    w->dev = nullptr;
    w->dev_bytes = 0;
    return false;
  }
  return true;
}

bool grow_host(Worker* w, size_t bytes) {
  if (bytes <= w->host_bytes) return true;
  if (w->host != nullptr) cudaFreeHost(w->host);
  w->host_bytes = std::max(bytes, kMinBuffer);
  if (cudaMallocHost(&w->host, w->host_bytes) != cudaSuccess) {
    w->host = nullptr;
    w->host_bytes = 0;
    return false;
  }
  return true;
}

// Decode one JPEG into w->host as interleaved RGB (h * w * 3). False on
// corrupt input or any nvJPEG / CUDA failure.
bool decode_one(Worker* w, const uint8_t* buf, size_t len, int* h, int* wd) {
  int components = 0;
  nvjpegChromaSubsampling_t subsampling;
  int widths[NVJPEG_MAX_COMPONENT] = {0};
  int heights[NVJPEG_MAX_COMPONENT] = {0};
  if (nvjpegGetImageInfo(g_handle, buf, len, &components, &subsampling, widths, heights) !=
      NVJPEG_STATUS_SUCCESS) {
    return false;
  }
  const int width = widths[0], height = heights[0];
  if (width <= 0 || height <= 0) return false;
  // Grayscale decodes to its one plane, replicated into RGB below.
  const bool gray = subsampling == NVJPEG_CSS_GRAY;
  const size_t pitch = static_cast<size_t>(width) * (gray ? 1 : 3);
  const size_t bytes = pitch * height;
  const size_t rgb_bytes = static_cast<size_t>(width) * height * 3;
  if (!grow_device(w, bytes) || !grow_host(w, rgb_bytes + bytes)) return false;
  nvjpegImage_t image;
  std::memset(&image, 0, sizeof(image));
  image.channel[0] = w->dev;
  image.pitch[0] = static_cast<unsigned int>(pitch);
  if (nvjpegDecode(g_handle, w->state, buf, len, gray ? NVJPEG_OUTPUT_Y : NVJPEG_OUTPUT_RGBI,
                   &image, w->stream) != NVJPEG_STATUS_SUCCESS) {
    return false;
  }
  unsigned char* staged = gray ? w->host + rgb_bytes : w->host;
  if (cudaMemcpyAsync(staged, w->dev, bytes, cudaMemcpyDeviceToHost, w->stream) != cudaSuccess ||
      cudaStreamSynchronize(w->stream) != cudaSuccess) {
    return false;
  }
  if (gray) {
    for (size_t i = 0; i < bytes; ++i) {
      std::memset(w->host + 3 * i, staged[i], 3);
    }
  }
  *h = height;
  *wd = width;
  return true;
}

// Bilinear resize (half-pixel centers), the same arithmetic as
// native/jpeg_decoder.cpp's, from (h, w, 3) to (out, out, 3).
void resize_bilinear(const uint8_t* src, int h, int w, uint8_t* dst, int out) {
  const float sy = static_cast<float>(h) / out;
  const float sx = static_cast<float>(w) / out;
  for (int oy = 0; oy < out; ++oy) {
    float fy = (oy + 0.5f) * sy - 0.5f;
    fy = std::max(0.0f, std::min(fy, static_cast<float>(h - 1)));
    const int y0 = static_cast<int>(fy);
    const int y1 = std::min(y0 + 1, h - 1);
    const float wy = fy - y0;
    for (int ox = 0; ox < out; ++ox) {
      float fx = (ox + 0.5f) * sx - 0.5f;
      fx = std::max(0.0f, std::min(fx, static_cast<float>(w - 1)));
      const int x0 = static_cast<int>(fx);
      const int x1 = std::min(x0 + 1, w - 1);
      const float wx = fx - x0;
      const uint8_t* p00 = src + (static_cast<size_t>(y0) * w + x0) * 3;
      const uint8_t* p01 = src + (static_cast<size_t>(y0) * w + x1) * 3;
      const uint8_t* p10 = src + (static_cast<size_t>(y1) * w + x0) * 3;
      const uint8_t* p11 = src + (static_cast<size_t>(y1) * w + x1) * 3;
      uint8_t* o = dst + (static_cast<size_t>(oy) * out + ox) * 3;
      for (int c = 0; c < 3; ++c) {
        const float top = p00[c] + (p01[c] - p00[c]) * wx;
        const float bot = p10[c] + (p11[c] - p10[c]) * wx;
        o[c] = static_cast<uint8_t>(top + (bot - top) * wy + 0.5f);
      }
    }
  }
}

}  // namespace

extern "C" {

// The ABI version of native/jpeg_decoder.cpp whose signature this mirrors.
int vt_api_version() { return 2; }

// 0 once nvJPEG and a CUDA device are ready; else a nonzero code: 1000 no
// device, 2000 + the nvjpegStatus_t of nvjpegCreateSimple.
int vt_nvjpeg_init() {
  std::lock_guard<std::mutex> lock(g_mu);
  if (g_init >= 0) return g_init;
  int devices = 0;
  if (cudaGetDeviceCount(&devices) != cudaSuccess || devices == 0) {
    g_init = 1000;
  } else {
    const nvjpegStatus_t st = nvjpegCreateSimple(&g_handle);
    g_init = st == NVJPEG_STATUS_SUCCESS ? 0 : 2000 + static_cast<int>(st);
  }
  return g_init;
}

// As native/jpeg_decoder.cpp: decode n JPEGs (concatenated in `data`, image i
// spanning [offsets[i], offsets[i+1])) into out[n, out_size, out_size, 3]
// uint8 RGB, resized bilinearly. status[i] = 0 ok, 1 decode error (output
// zeroed). Returns the number of failures. Runs on n_threads host threads.
int vt_decode_jpeg_batch(const uint8_t* data, const int64_t* offsets, int n, int out_size,
                         uint8_t* out, int64_t* status, int n_threads, int /*flags*/) {
  const size_t out_stride = static_cast<size_t>(out_size) * out_size * 3;
  if (vt_nvjpeg_init() != 0) {
    std::memset(out, 0, out_stride * n);
    for (int i = 0; i < n; ++i) status[i] = 1;
    return n;
  }
  std::atomic<int> next(0);
  std::atomic<int> failures(0);

  auto worker = [&]() {
    Worker* w = acquire();
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) break;
      uint8_t* dst = out + i * out_stride;
      int h = 0, wd = 0;
      const size_t len = static_cast<size_t>(offsets[i + 1] - offsets[i]);
      if (w == nullptr || !decode_one(w, data + offsets[i], len, &h, &wd)) {
        std::memset(dst, 0, out_stride);
        status[i] = 1;
        failures.fetch_add(1);
        continue;
      }
      if (h == out_size && wd == out_size) {
        std::memcpy(dst, w->host, out_stride);
      } else {
        resize_bilinear(w->host, h, wd, dst, out_size);
      }
      status[i] = 0;
    }
    if (w != nullptr) release(w);
  };

  n_threads = std::max(1, std::min(n_threads, n));
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return failures.load();
}

}  // extern "C"
