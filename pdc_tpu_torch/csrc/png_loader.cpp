// png_loader: the host-side PNG decoder and encoder pool of pdc_tpu_torch.
//
// The port's own copy of native/pdc_loader.cpp (the JAX package's loader),
// unchanged in what it computes: libpng's simplified API for the three pdc
// image kinds (RGB8 frames, 16-bit depth, 8-bit masks, where a mask's
// nonzero values become 1) and their encoders, run by a persistent pthread
// pool that decodes a batch of files in parallel straight into
// caller-provided numpy buffers.
//
// Built on the host, not by nvcc: pdc_tpu_torch/ops/_build.py runs
// g++ -O3 -fPIC -shared ... -lpng -lz -lpthread into
// build/pdc_tpu_torch_kernels/ at first use. Bound with ctypes in
// pdc_tpu_torch/data/native_loader.py, whose plain numpy/zlib codec gives
// the same arrays where libpng is missing.

#include <png.h>
#include <pthread.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <atomic>
#include <condition_variable>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// single-image decoders
// ---------------------------------------------------------------------------

// Decode an 8-bit image into RGB; returns 0 on success.
// out must hold height*width*3 bytes; expected dims are verified.
int decode_png_rgb8(const char* path, uint8_t* out, int expect_h, int expect_w) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return -1;
  png_image image;
  memset(&image, 0, sizeof(image));
  image.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_stdio(&image, fp)) {
    fclose(fp);
    return -2;
  }
  image.format = PNG_FORMAT_RGB;
  if ((int)image.height != expect_h || (int)image.width != expect_w) {
    png_image_free(&image);
    fclose(fp);
    return -3;
  }
  int ok = png_image_finish_read(&image, nullptr, out, 0, nullptr);
  fclose(fp);
  return ok ? 0 : -4;
}

// Decode a 16-bit grayscale (depth) image; out holds height*width uint16.
// libpng's simplified API returns host-endian 16-bit with PNG_FORMAT_LINEAR_Y,
// but that applies gamma handling for 8-bit sources; pdc depth PNGs are
// always 16-bit grayscale so the values pass through unchanged.
int decode_png_gray16(const char* path, uint16_t* out, int expect_h, int expect_w) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return -1;
  png_image image;
  memset(&image, 0, sizeof(image));
  image.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_stdio(&image, fp)) {
    fclose(fp);
    return -2;
  }
  image.format = PNG_FORMAT_LINEAR_Y;  // 16-bit grayscale
  if ((int)image.height != expect_h || (int)image.width != expect_w) {
    png_image_free(&image);
    fclose(fp);
    return -3;
  }
  int ok = png_image_finish_read(&image, nullptr, out, 0, nullptr);
  fclose(fp);
  return ok ? 0 : -4;
}

// Decode an 8-bit grayscale (mask) image; nonzero -> 1.
int decode_png_mask8(const char* path, uint8_t* out, int expect_h, int expect_w) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return -1;
  png_image image;
  memset(&image, 0, sizeof(image));
  image.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_stdio(&image, fp)) {
    fclose(fp);
    return -2;
  }
  image.format = PNG_FORMAT_GRAY;
  if ((int)image.height != expect_h || (int)image.width != expect_w) {
    png_image_free(&image);
    fclose(fp);
    return -3;
  }
  int ok = png_image_finish_read(&image, nullptr, out, 0, nullptr);
  if (ok) {
    size_t n = (size_t)expect_h * expect_w;
    for (size_t i = 0; i < n; ++i) out[i] = out[i] ? 1 : 0;
  }
  fclose(fp);
  return ok ? 0 : -4;
}

// ---------------------------------------------------------------------------
// single-image encoders (the preprocessing pipeline writes hundreds of mask
// + depth PNGs per log; PIL writes are serial on the host)
// ---------------------------------------------------------------------------

// Encode an 8-bit grayscale image (masks, values as given).
int encode_png_gray8(const char* path, const uint8_t* data, int h, int w) {
  png_image image;
  memset(&image, 0, sizeof(image));
  image.version = PNG_IMAGE_VERSION;
  image.width = (png_uint_32)w;
  image.height = (png_uint_32)h;
  image.format = PNG_FORMAT_GRAY;
  return png_image_write_to_file(&image, path, 0, data, 0, nullptr) ? 0 : -4;
}

// Encode a 16-bit grayscale (depth, mm) image — the inverse of
// decode_png_gray16 (PNG_FORMAT_LINEAR_Y passes 16-bit values through).
int encode_png_gray16(const char* path, const uint16_t* data, int h, int w) {
  png_image image;
  memset(&image, 0, sizeof(image));
  image.version = PNG_IMAGE_VERSION;
  image.width = (png_uint_32)w;
  image.height = (png_uint_32)h;
  image.format = PNG_FORMAT_LINEAR_Y;
  return png_image_write_to_file(&image, path, 0, data, 0, nullptr) ? 0 : -4;
}

// Encode an 8-bit RGB image.
int encode_png_rgb8(const char* path, const uint8_t* data, int h, int w) {
  png_image image;
  memset(&image, 0, sizeof(image));
  image.version = PNG_IMAGE_VERSION;
  image.width = (png_uint_32)w;
  image.height = (png_uint_32)h;
  image.format = PNG_FORMAT_RGB;
  return png_image_write_to_file(&image, path, 0, data, 0, nullptr) ? 0 : -4;
}

// ---------------------------------------------------------------------------
// worker pool for batch decode/encode
// ---------------------------------------------------------------------------

struct Task {
  const char* path;
  void* out;
  int kind;  // 0 = rgb8, 1 = gray16, 2 = mask8; +3 = the encode counterparts
  int h, w;
  std::atomic<int>* err;
  std::atomic<int>* remaining;
};

class Pool {
 public:
  explicit Pool(int n_threads) : stop_(false) {
    for (int i = 0; i < n_threads; ++i)
      threads_.emplace_back([this] { worker(); });
  }
  ~Pool() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : threads_) t.join();
  }
  void submit(const Task& t) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      tasks_.push(t);
    }
    cv_.notify_one();
  }

 private:
  void worker() {
    for (;;) {
      Task t;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || !tasks_.empty(); });
        if (stop_ && tasks_.empty()) return;
        t = tasks_.front();
        tasks_.pop();
      }
      int rc = 0;
      switch (t.kind) {
        case 0: rc = decode_png_rgb8(t.path, (uint8_t*)t.out, t.h, t.w); break;
        case 1: rc = decode_png_gray16(t.path, (uint16_t*)t.out, t.h, t.w); break;
        case 2: rc = decode_png_mask8(t.path, (uint8_t*)t.out, t.h, t.w); break;
        case 3: rc = encode_png_rgb8(t.path, (const uint8_t*)t.out, t.h, t.w); break;
        case 4: rc = encode_png_gray16(t.path, (const uint16_t*)t.out, t.h, t.w); break;
        case 5: rc = encode_png_gray8(t.path, (const uint8_t*)t.out, t.h, t.w); break;
        default: rc = -100;
      }
      if (rc != 0) t.err->store(rc);
      t.remaining->fetch_sub(1);
    }
  }

  std::vector<std::thread> threads_;
  std::queue<Task> tasks_;
  std::mutex mu_;
  std::condition_variable cv_;
  bool stop_;
};

static Pool* g_pool = nullptr;
static int g_pool_size = 0;

void loader_init(int n_threads) {
  if (g_pool && g_pool_size == n_threads) return;
  delete g_pool;
  g_pool = new Pool(n_threads);
  g_pool_size = n_threads;
}

void loader_shutdown() {
  delete g_pool;
  g_pool = nullptr;
  g_pool_size = 0;
}

// Decode a batch in parallel. paths: array of n C strings; kinds: per-image
// kind codes; outs: per-image destination pointers. Blocks until all are
// done; returns 0 or the first nonzero decoder error.
int decode_batch(const char** paths, const int* kinds, void** outs, int n,
                 int h, int w) {
  if (!g_pool) loader_init((int)std::thread::hardware_concurrency());
  std::atomic<int> err(0);
  std::atomic<int> remaining(n);
  for (int i = 0; i < n; ++i) {
    Task t{paths[i], outs[i], kinds[i], h, w, &err, &remaining};
    g_pool->submit(t);
  }
  while (remaining.load() > 0) std::this_thread::yield();
  return err.load();
}

// Encode a batch in parallel (kinds use the encode codes 3/4/5; ins are the
// per-image source buffers). Blocks until all writes finish; returns 0 or
// the first nonzero encoder error.
int encode_batch(const char** paths, const int* kinds, void** ins, int n,
                 int h, int w) {
  return decode_batch(paths, kinds, ins, n, h, w);
}

}  // extern "C"
