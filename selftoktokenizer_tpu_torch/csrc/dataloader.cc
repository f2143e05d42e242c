// Host-side image loader of the PyTorch port (selftoktokenizer_tpu_torch).
//
// The same code as the reference package's native/dataloader.cc, so both
// decode to the same bits:
//
//   JPEG/PNG decode (libjpeg / libpng; grayscale, palette and alpha PNGs
//   come out as RGB) -> bilinear shortest-side resize (PIL's triangle
//   filter) -> centre crop (torchvision's offsets) -> float32 [-1, 1] NHWC
//
// plus a multithreaded prefetching batch loader with a bounded ring of
// ready batches. A plain C interface, bound with ctypes by data/native.py.
// ops/_build.py compiles it with g++ at first use:
//
//   g++ -O3 -fPIC -std=c++17 -Wall -pthread -shared dataloader.cc -ljpeg -lpng

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>
#include <png.h>

#include <atomic>
#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Image {
  int w = 0, h = 0;
  std::vector<uint8_t> rgb;  // HWC, 3 channels
  bool ok = false;
};

// ----------------------------------------------------------------- decode

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  auto* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

Image decode_jpeg(const uint8_t* data, size_t len) {
  Image out;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return out;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return out;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out.w = cinfo.output_width;
  out.h = cinfo.output_height;
  out.rgb.resize(size_t(out.w) * out.h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out.rgb.data() + size_t(cinfo.output_scanline) * out.w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  out.ok = true;
  return out;
}

struct PngReadState {
  const uint8_t* data;
  size_t len, pos;
};

void png_read_fn(png_structp png, png_bytep dst, png_size_t n) {
  auto* s = static_cast<PngReadState*>(png_get_io_ptr(png));
  if (s->pos + n > s->len) {
    png_error(png, "eof");
    return;
  }
  memcpy(dst, s->data + s->pos, n);
  s->pos += n;
}

Image decode_png(const uint8_t* data, size_t len) {
  Image out;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
  if (!png) return out;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return out;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return out;
  }
  PngReadState st{data, len, 0};
  png_set_read_fn(png, &st, png_read_fn);
  png_read_info(png, info);
  png_uint_32 w, h;
  int bit_depth, color_type;
  png_get_IHDR(png, info, &w, &h, &bit_depth, &color_type, nullptr, nullptr,
               nullptr);
  if (bit_depth == 16) png_set_strip_16(png);
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color_type == PNG_COLOR_TYPE_GRAY ||
      color_type == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  png_set_strip_alpha(png);
  png_read_update_info(png, info);
  out.w = int(w);
  out.h = int(h);
  out.rgb.resize(size_t(w) * h * 3);
  std::vector<png_bytep> rows(h);
  for (png_uint_32 y = 0; y < h; y++)
    rows[y] = out.rgb.data() + size_t(y) * w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  out.ok = true;
  return out;
}

Image decode_any(const uint8_t* data, size_t len) {
  if (len > 3 && data[0] == 0xFF && data[1] == 0xD8) return decode_jpeg(data, len);
  if (len > 8 && png_sig_cmp(const_cast<png_bytep>(data), 0, 8) == 0)
    return decode_png(data, len);
  // fall back to trying jpeg
  return decode_jpeg(data, len);
}

// -------------------------------------------------- resize / crop / norm

// Separable triangle-filter resampling, matching PIL's BILINEAR semantics:
// on downscale the kernel support widens with the scale factor (area-
// adaptive), not a fixed 2-tap lookup. Horizontal pass then vertical pass,
// float accumulators.
struct ResampleCoeffs {
  std::vector<int> lo;                 // first source index per output pixel
  std::vector<std::vector<float>> w;   // normalized weights per output pixel
};

ResampleCoeffs triangle_coeffs(int in_size, int out_size) {
  ResampleCoeffs rc;
  rc.lo.resize(out_size);
  rc.w.resize(out_size);
  double scale = double(in_size) / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = 1.0 * filterscale;  // bilinear support = 1
  for (int x = 0; x < out_size; x++) {
    double center = (x + 0.5) * scale;
    int xmin = int(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = int(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    rc.lo[x] = xmin;
    auto& ws = rc.w[x];
    ws.resize(xmax - xmin);
    double total = 0.0;
    for (int i = xmin; i < xmax; i++) {
      double d = (i - center + 0.5) / filterscale;
      double v = d < 0 ? -d : d;
      v = v >= 1.0 ? 0.0 : 1.0 - v;
      ws[i - xmin] = float(v);
      total += v;
    }
    if (total > 0)
      for (auto& v : ws) v = float(v / total);
  }
  return rc;
}

void resize_bilinear(const Image& src, int nw, int nh,
                     std::vector<uint8_t>* dst) {
  ResampleCoeffs cx = triangle_coeffs(src.w, nw);
  ResampleCoeffs cy = triangle_coeffs(src.h, nh);
  // horizontal pass: [h, w, 3] -> [h, nw, 3] floats
  std::vector<float> tmp(size_t(src.h) * nw * 3);
  for (int y = 0; y < src.h; y++) {
    const uint8_t* row = src.rgb.data() + size_t(y) * src.w * 3;
    float* orow = tmp.data() + size_t(y) * nw * 3;
    for (int x = 0; x < nw; x++) {
      const auto& ws = cx.w[x];
      int lo = cx.lo[x];
      float acc[3] = {0, 0, 0};
      for (size_t i = 0; i < ws.size(); i++) {
        const uint8_t* px = row + size_t(lo + i) * 3;
        acc[0] += ws[i] * px[0];
        acc[1] += ws[i] * px[1];
        acc[2] += ws[i] * px[2];
      }
      orow[x * 3 + 0] = acc[0];
      orow[x * 3 + 1] = acc[1];
      orow[x * 3 + 2] = acc[2];
    }
  }
  // vertical pass
  dst->resize(size_t(nw) * nh * 3);
  for (int y = 0; y < nh; y++) {
    const auto& ws = cy.w[y];
    int lo = cy.lo[y];
    uint8_t* orow = dst->data() + size_t(y) * nw * 3;
    for (int x = 0; x < nw * 3; x++) {
      float acc = 0;
      for (size_t i = 0; i < ws.size(); i++)
        acc += ws[i] * tmp[size_t(lo + i) * nw * 3 + x];
      int v = int(acc + 0.5f);
      orow[x] = uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
  }
}

// shortest-side resize -> center crop -> normalize to [-1,1] float32 NHWC
bool preprocess_to(const Image& img, int size, float* out) {
  if (!img.ok || img.w <= 0 || img.h <= 0) return false;
  // torchvision semantics: long side truncated int(size*long/short);
  // center-crop offsets rounded
  int nw, nh;
  if (img.w < img.h) {
    nw = size;
    nh = int(double(size) * img.h / img.w);
  } else {
    nh = size;
    nw = int(double(size) * img.w / img.h);
  }
  std::vector<uint8_t> resized;
  resize_bilinear(img, nw, nh, &resized);
  // python round() is banker's rounding; offsets are X.0 or X.5 exactly
  auto round_half_even = [](int num) {  // num/2 rounded half-to-even
    int q = num / 2;
    if (num % 2 == 0) return q;
    return (q % 2 == 0) ? q : q + 1;
  };
  int left = round_half_even(nw - size);
  int top = round_half_even(nh - size);
  for (int y = 0; y < size; y++) {
    const uint8_t* row = resized.data() + (size_t(y + top) * nw + left) * 3;
    float* orow = out + size_t(y) * size * 3;
    for (int i = 0; i < size * 3; i++)
      orow[i] = row[i] / 127.5f - 1.0f;
  }
  return true;
}

// ------------------------------------------------------ prefetch loader

struct Batch {
  std::vector<float> data;     // [B, size, size, 3]
  std::vector<long> indices;   // source path index per valid row
  int count = 0;
};

struct Loader {
  std::vector<std::string> paths;
  int size = 256, batch = 16, queue_cap = 4;
  std::atomic<size_t> next{0};
  std::deque<Batch> ready;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};
  std::atomic<long> decoded{0}, failed{0};

  void worker() {
    while (!stop.load()) {
      size_t start = next.fetch_add(batch);
      if (start >= paths.size()) break;
      Batch b;
      size_t n = std::min(size_t(batch), paths.size() - start);
      b.data.assign(size_t(batch) * size * size * 3, 0.0f);
      int count = 0;
      for (size_t i = 0; i < n; i++) {
        FILE* f = fopen(paths[start + i].c_str(), "rb");
        if (!f) { failed++; continue; }
        fseek(f, 0, SEEK_END);
        long len = ftell(f);
        fseek(f, 0, SEEK_SET);
        if (len <= 0) { fclose(f); failed++; continue; }  // ftell failure / empty
        std::vector<uint8_t> buf(len);
        size_t got = fread(buf.data(), 1, len, f);
        fclose(f);
        if ((long)got != len) { failed++; continue; }
        Image img = decode_any(buf.data(), buf.size());
        if (!preprocess_to(img, size,
                           b.data.data() + size_t(count) * size * size * 3)) {
          failed++;
          continue;
        }
        b.indices.push_back(long(start + i));
        count++;
        decoded++;
      }
      b.count = count;
      std::unique_lock<std::mutex> lk(mu);
      cv_space.wait(lk, [&] {
        return stop.load() || (int)ready.size() < queue_cap;
      });
      if (stop.load()) break;
      ready.push_back(std::move(b));
      cv_ready.notify_one();
    }
    std::unique_lock<std::mutex> lk(mu);
    done_workers++;
    cv_ready.notify_all();
  }

  int done_workers = 0;
  int n_workers = 0;
};

}  // namespace

extern "C" {

// One-shot preprocess: file -> float32 [size,size,3] buffer. Returns 1 on ok.
int stk_preprocess_file(const char* path, int size, float* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return 0;
  fseek(f, 0, SEEK_END);
  long len = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (len <= 0) { fclose(f); return 0; }
  std::vector<uint8_t> buf(len);
  size_t got = fread(buf.data(), 1, len, f);
  fclose(f);
  if ((long)got != len) return 0;
  Image img = decode_any(buf.data(), buf.size());
  return preprocess_to(img, size, out) ? 1 : 0;
}

// Decode+preprocess from an in-memory buffer.
int stk_preprocess_bytes(const uint8_t* data, long len, int size, float* out) {
  Image img = decode_any(data, size_t(len));
  return preprocess_to(img, size, out) ? 1 : 0;
}

void* stk_loader_create(const char** paths, long n_paths, int size, int batch,
                        int n_threads, int queue_cap) {
  auto* l = new Loader();
  l->paths.assign(paths, paths + n_paths);
  l->size = size;
  l->batch = batch;
  l->queue_cap = queue_cap > 0 ? queue_cap : 4;
  l->n_workers = n_threads > 0 ? n_threads : 4;
  for (int i = 0; i < l->n_workers; i++)
    l->workers.emplace_back([l] { l->worker(); });
  return l;
}

// Pops the next ready batch into out ([batch,size,size,3] float32) and the
// source path index of each valid row into indices (length >= batch).
// Returns the number of valid images, or -1 when exhausted.
// Batches complete in worker order, NOT path order — consumers must use
// the indices for any token<->path association.
int stk_loader_next(void* handle, float* out, long* indices) {
  auto* l = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lk(l->mu);
  l->cv_ready.wait(lk, [&] {
    return !l->ready.empty() || l->done_workers == l->n_workers;
  });
  if (l->ready.empty()) return -1;
  Batch b = std::move(l->ready.front());
  l->ready.pop_front();
  l->cv_space.notify_one();
  lk.unlock();
  memcpy(out, b.data.data(), b.data.size() * sizeof(float));
  if (indices)
    for (int i = 0; i < b.count; i++) indices[i] = b.indices[i];
  return b.count;
}

void stk_loader_destroy(void* handle) {
  auto* l = static_cast<Loader*>(handle);
  l->stop.store(true);
  l->cv_space.notify_all();
  l->cv_ready.notify_all();
  for (auto& t : l->workers) t.join();
  delete l;
}

long stk_loader_stats(void* handle, long* failed) {
  auto* l = static_cast<Loader*>(handle);
  if (failed) *failed = l->failed.load();
  return l->decoded.load();
}

}  // extern "C"
