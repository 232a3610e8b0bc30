// Native stereo-frame loader: libpng decode + background prefetch ring.
//
// Counterpart of the reference's dataset layer
// (KittiDataset lazy imread, ref src/dataset.cpp:108-124): a worker
// thread decodes upcoming stereo pairs into a fixed ring of float32
// buffers while the device crunches the current frame, so host decode
// never sits on the critical path. Exposed as a plain C API consumed
// from Python via ctypes (no pybind11 in this environment).
//
// Build: see native/build.sh (g++ -O2 -shared -fPIC loader.cpp -lpng -lpthread)

#include <png.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Frame {
  std::vector<float> left, right;
  int index = -1;
  bool ok = false;
};

bool decode_png_gray(const std::string& path, std::vector<float>* out,
                     int expect_h, int expect_w) {
  FILE* fp = std::fopen(path.c_str(), "rb");
  if (!fp) return false;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return false;
  }
  png_init_io(png, fp);
  png_read_info(png, info);
  png_uint_32 w = png_get_image_width(png, info);
  png_uint_32 h = png_get_image_height(png, info);
  int color = png_get_color_type(png, info);
  int depth = png_get_bit_depth(png, info);
  // normalize to 8-bit grayscale
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (depth == 16) png_set_strip_16(png);
  if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  if (color == PNG_COLOR_TYPE_RGB || color == PNG_COLOR_TYPE_RGB_ALPHA ||
      color == PNG_COLOR_TYPE_PALETTE)
    png_set_rgb_to_gray_fixed(png, 1, -1, -1);
  png_read_update_info(png, info);

  if ((int)h != expect_h || (int)w != expect_w) {
    // size mismatch: still decode, caller sized buffers to expect_*; bail
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return false;
  }
  std::vector<uint8_t> row(w);
  out->resize((size_t)h * w);
  for (png_uint_32 y = 0; y < h; ++y) {
    png_read_row(png, row.data(), nullptr);
    float* dst = out->data() + (size_t)y * w;
    for (png_uint_32 x = 0; x < w; ++x) dst[x] = (float)row[x];
  }
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  return true;
}

struct Loader {
  std::vector<std::string> left_paths, right_paths;
  int height = 0, width = 0;
  int ring_cap = 4;

  std::vector<Frame> ring;
  std::mutex mu;
  std::condition_variable cv_produce, cv_consume;
  int next_decode = 0;   // next frame index the worker will decode
  int next_read = 0;     // next frame index the consumer will take
  int filled = 0;
  std::atomic<bool> stop{false};
  std::thread worker;

  void run() {
    while (!stop.load()) {
      int idx;
      Frame local;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_produce.wait(lk, [&] {
          return stop.load() || (filled < ring_cap &&
                                 next_decode < (int)left_paths.size());
        });
        if (stop.load() || next_decode >= (int)left_paths.size()) return;
        idx = next_decode++;
      }
      local.index = idx;
      local.ok = decode_png_gray(left_paths[idx], &local.left, height, width) &&
                 decode_png_gray(right_paths[idx], &local.right, height, width);
      {
        std::unique_lock<std::mutex> lk(mu);
        ring[idx % ring_cap] = std::move(local);
        ++filled;
      }
      cv_consume.notify_one();
    }
  }
};

}  // namespace

extern "C" {

void* loader_open(const char** left_paths, const char** right_paths, int n,
                  int height, int width, int ring) {
  auto* L = new Loader();
  L->left_paths.assign(left_paths, left_paths + n);
  L->right_paths.assign(right_paths, right_paths + n);
  L->height = height;
  L->width = width;
  L->ring_cap = ring > 0 ? ring : 4;
  L->ring.resize(L->ring_cap);
  L->worker = std::thread([L] { L->run(); });
  return L;
}

// Blocks until frame `next_read` is decoded; copies into out_{l,r}
// (height*width float32). Returns the frame index, or -1 at end/error.
int loader_next(void* handle, float* out_l, float* out_r) {
  auto* L = static_cast<Loader*>(handle);
  if (L->next_read >= (int)L->left_paths.size()) return -1;
  Frame frame;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    int want = L->next_read;
    L->cv_consume.wait(lk, [&] {
      const Frame& f = L->ring[want % L->ring_cap];
      return L->stop.load() || (f.index == want);
    });
    if (L->stop.load()) return -1;
    frame = std::move(L->ring[want % L->ring_cap]);
    L->ring[want % L->ring_cap].index = -1;
    --L->filled;
    ++L->next_read;
  }
  L->cv_produce.notify_one();
  if (!frame.ok) return -1;
  size_t sz = (size_t)L->height * L->width;
  std::memcpy(out_l, frame.left.data(), sz * sizeof(float));
  std::memcpy(out_r, frame.right.data(), sz * sizeof(float));
  return frame.index;
}

void loader_close(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  L->stop.store(true);
  L->cv_produce.notify_all();
  L->cv_consume.notify_all();
  if (L->worker.joinable()) L->worker.join();
  delete L;
}

// One-shot decode helper (no prefetch), for tests and tooling.
int decode_gray(const char* path, float* out, int height, int width) {
  std::vector<float> buf;
  if (!decode_png_gray(path, &buf, height, width)) return -1;
  std::memcpy(out, buf.data(), buf.size() * sizeof(float));
  return 0;
}

}  // extern "C"
