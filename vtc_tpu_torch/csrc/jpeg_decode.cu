// JPEG decode on the card: nvJPEG for the entropy decode and the IDCT, and a
// hand-written kernel for libjpeg-turbo's chroma upsampling and YCbCr -> RGB.
//
// Not a port of a TPU kernel: the JAX package decodes its thumbnails on the
// host with PIL (vtc_tpu/data/datasets.py, ImTextDataset.__getitem__), that
// is with libjpeg-turbo, and the machine with the card has no PIL. This file
// is a plain C binding for ctypes (vtc_tpu_torch/data/image_io.py):
//
// * one nvjpegHandle_t per process, made on first use;
// * one nvjpegJpegState_t per calling thread (the loader's workers are
//   threads), destroyed when the thread exits;
// * each decode runs on the stream the caller passes (the wrapper gives each
//   thread a stream of its own and allocates the planes on it, so no other
//   stream's work orders or races the decode) and synchronizes it before it
//   returns, so the caller's bytes are no longer needed.
//
// nvJPEG stops before colour conversion: NVJPEG_OUTPUT_YUV gives the Y, Cb
// and Cr planes at their own sizes (for 4:2:0 the chroma is ceil(w/2) x
// ceil(h/2)) for the six samplings it takes (the luma full size, Cb and Cr
// alike: 4:4:4, 4:2:2, 4:4:0, 4:2:0, 4:1:1, 4:1:0); a grayscale image gives its
// Y plane (NVJPEG_OUTPUT_Y); every other image its planes as coded
// (NVJPEG_OUTPUT_UNCHANGED: a 4-component one, Cb and Cr sampled apart, a luma
// sampled below the chroma, factors such as 1 x 4 or 3 x 1). nvJPEG's own
// RGB output upsamples the chroma otherwise than libjpeg-turbo, 1.28-4.88
// levels off PIL per channel on 4:2:0 images, so the upsampling and the
// colour conversion are done here, by `ycc_to_rgb_kernel`, as libjpeg-turbo
// does them, plane by plane (jinit_upsampler in jdsample.c picks a method for
// each component from the largest sampling factors over its own, hf x vf):
//
// * 1 x 1: the plane as it is;
// * "fancy" upsampling: h2v1_fancy_upsample for 2 x 1 ((3 cur + prev + 1) >> 2,
//   (3 cur + next + 2) >> 2), h1v2_fancy_upsample for 1 x 2 (biases 1 and 2,
//   >> 2) and h2v2_fancy_upsample for 2 x 2 (a vertical 3:1 column sum with the
//   row above or below, then a horizontal 3:1 mix with biases 8 and 7, >> 4).
//   At the left and right edges and at the top and bottom rows (jdmainct.c's
//   context rows) the edge sample stands in for the missing neighbour, which
//   gives the edge columns' special cases of jdsample.c;
// * a box: a plane 2 samples wide or less upsampled 2 x 1 or 2 x 2
//   (h2v1_upsample, h2v2_upsample), and every other whole ratio (int_upsample:
//   4 x 1, 4 x 2, 1 x 4, 3 x 1 ..., each sample repeated over its hf x vf box).
//   A fractional ratio is refused from the header by the wrapper, as
//   libjpeg-turbo refuses it (JERR_FRACT_SAMPLE_NOTIMPL);
// * YCbCr -> RGB with the integer tables of jdcolor.c (build_ycc_rgb_table,
//   SCALEBITS 16), each result clamped to 0-255; for a JPEG coded in RGB
//   (transform = 0: an Adobe segment with colour transform 0, or the ids R,
//   G, B) the three planes are R, G and B, and they are upsampled alike and
//   written as they are (rgb_rgb_convert);
// * a fourth plane K (mode 2: CMYK, whose planes hold Adobe's inverted C, M,
//   Y; mode 3: YCCK, whose Y, Cb, Cr go through the YCbCr tables first, as
//   jdcolor.c's ycck_cmyk_convert) makes RGB as PIL's cmyk2rgb does
//   (Convert.c): K - MULDIV255(c, K) per channel, clamped.
//
// Output pixel (x, y) reads plane column x / hf, row y / vf and, for the
// fancy methods, the neighbour its half of the sample leans to.
//
// Bound: it reads every plane once (w*h + 2*cw*ch bytes at 4:2:0, and w*h of
// K) and writes 3*w*h; at thumbnail sizes (480 x 360: 0.86 MB) that is 0.26
// us at 3.35 TB/s, so the launch and the decode's synchronizations set its
// time. One thread writes one output pixel pair (the two pixels of a sample
// upsampled 2 across share its column sums); a block is 128 pairs of one row.
//
// Return codes: 0, an nvjpegStatus_t (1-10), or 1000 + a cudaError_t.

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <cstdint>
#include <mutex>

// a plane on the card: its rows, its size, its upsampling across and down (the
// layout of image_io._Plane)
struct Plane {
  const uint8_t* p;
  int pitch, w, h, hf, vf;
};

namespace {

nvjpegHandle_t g_handle = nullptr;
nvjpegStatus_t g_handle_status = NVJPEG_STATUS_SUCCESS;
std::once_flag g_handle_once;

nvjpegHandle_t handle(nvjpegStatus_t* status) {
  std::call_once(g_handle_once, [] { g_handle_status = nvjpegCreateSimple(&g_handle); });
  *status = g_handle_status;
  return g_handle;
}

// a thread's decoder state, released when the thread exits
struct ThreadState {
  nvjpegJpegState_t state = nullptr;
  ~ThreadState() {
    if (state) nvjpegJpegStateDestroy(state);
  }
};

thread_local ThreadState t_state;

constexpr int kPairsPerBlock = 128;

// jdcolor.c: FIX(x) = (int)(x * 65536 + 0.5), ONE_HALF = 1 << 15
constexpr int kCrR = 91881;   // FIX(1.40200)
constexpr int kCbB = 116130;  // FIX(1.77200)
constexpr int kCrG = 46802;   // FIX(0.71414)
constexpr int kCbG = 22554;   // FIX(0.34414)
constexpr int kHalf = 1 << 15;

struct Planes {
  Plane plane[4];
};

__device__ __forceinline__ int sample(const Plane& pl, int row, int col) {
  return pl.p[static_cast<size_t>(row) * pl.pitch + col];
}

// The plane's values at output pixels (x0, y) and (x0 + 1, y), x0 even, as
// jinit_upsampler's method for its factors computes them. The two pixels of
// a sample upsampled 2 across share its column (and column sums); the pixel
// past an odd width is computed from the last column and not written.
__device__ __forceinline__ void upsample_pair(const Plane& pl, int x0, int y, int w,
                                              int out[2]) {
  const int hf = pl.hf, vf = pl.vf;
  const int x1 = min(x0 + 1, w - 1);
  if (hf == 1 && vf == 1) {
    out[0] = sample(pl, y, x0);
    out[1] = sample(pl, y, x1);
    return;
  }
  const bool fancy = (hf == 1 && vf == 2) || (hf == 2 && vf <= 2 && pl.w > 2);
  if (!fancy) {  // h2v1_upsample, h2v2_upsample, int_upsample: the box
    const int r = y / vf;
    out[0] = sample(pl, r, x0 / hf);
    out[1] = sample(pl, r, x1 / hf);
    return;
  }
  if (vf == 1) {  // h2v1_fancy_upsample
    const int c = x0 >> 1;
    const int cur = 3 * sample(pl, y, c);
    out[0] = (cur + sample(pl, y, max(c - 1, 0)) + 1) >> 2;
    out[1] = (cur + sample(pl, y, min(c + 1, pl.w - 1)) + 2) >> 2;
    return;
  }
  // the nearer row weighted 3: the row above for even output rows
  const int r = y >> 1, below = y & 1;
  const int rn = below ? min(r + 1, pl.h - 1) : max(r - 1, 0);
  if (hf == 1) {  // h1v2_fancy_upsample
    out[0] = (3 * sample(pl, r, x0) + sample(pl, rn, x0) + 1 + below) >> 2;
    out[1] = (3 * sample(pl, r, x1) + sample(pl, rn, x1) + 1 + below) >> 2;
    return;
  }
  // h2v2_fancy_upsample: column sums, then the nearer column weighted 3
  const int c = x0 >> 1;
  const int cl = max(c - 1, 0), cr = min(c + 1, pl.w - 1);
  const int s = 3 * sample(pl, r, c) + sample(pl, rn, c);
  const int sl = 3 * sample(pl, r, cl) + sample(pl, rn, cl);
  const int sr = 3 * sample(pl, r, cr) + sample(pl, rn, cr);
  out[0] = (3 * s + sl + 8) >> 4;
  out[1] = (3 * s + sr + 7) >> 4;
}

__device__ __forceinline__ uint8_t clamp255(int v) {
  return static_cast<uint8_t>(min(max(v, 0), 255));
}

// PIL's MULDIV255(a, b): a * b / 255, rounded as Convert.c rounds it
__device__ __forceinline__ int muldiv255(int a, int b) {
  int t = a * b + 128;
  return ((t >> 8) + t) >> 8;
}

// mode: 0 R, G, B planes; 1 YCbCr; 2 CMYK (Adobe-inverted) with K; 3 YCCK with K
__global__ void ycc_to_rgb_kernel(Planes planes, int w, int h, int mode,
                                  uint8_t* __restrict__ out, int out_pitch) {
  const int x0 = 2 * (blockIdx.x * kPairsPerBlock + threadIdx.x);
  const int row = blockIdx.y;
  if (x0 >= w || row >= h) return;
  // each plane by a constant index: the values stay in registers
  int vy[2], vcb[2], vcr[2], vk[2] = {0, 0};
  upsample_pair(planes.plane[0], x0, row, w, vy);
  upsample_pair(planes.plane[1], x0, row, w, vcb);
  upsample_pair(planes.plane[2], x0, row, w, vcr);
  if (mode & 2) upsample_pair(planes.plane[3], x0, row, w, vk);
  uint8_t* o = out + static_cast<size_t>(row) * out_pitch + 3 * x0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (x0 + i >= w) break;
    const int luma = vy[i], cb = vcb[i], cr = vcr[i];
    int c[3] = {luma, cb, cr};
    if (mode & 1) {
      const int dcb = cb - 128, dcr = cr - 128;
      // arithmetic shifts of signed ints, as jdcolor.c's RIGHT_SHIFT
      c[0] = clamp255(luma + ((kCrR * dcr + kHalf) >> 16));
      c[1] = clamp255(luma + ((-kCbG * dcb + kHalf - kCrG * dcr) >> 16));
      c[2] = clamp255(luma + ((kCbB * dcb + kHalf) >> 16));
    }
    if (mode & 2) {  // PIL's C, M, Y: 255 - plane (CMYK) or the tables' (YCCK)
      const int kk = vk[i];
      for (int j = 0; j < 3; ++j) {
        c[j] = clamp255(kk - muldiv255(mode == 2 ? 255 - c[j] : c[j], kk));
      }
    }
    for (int j = 0; j < 3; ++j) o[3 * i + j] = static_cast<uint8_t>(c[j]);
  }
}

}  // namespace

extern "C" {

// Each component's plane size, as nvJPEG reads it from the header (the
// components and their sampling come from image_io's own header parse).
int vtc_jpeg_info(const unsigned char* data, size_t len, int* widths, int* heights) {
  nvjpegStatus_t s;
  nvjpegHandle_t h = handle(&s);
  if (s != NVJPEG_STATUS_SUCCESS) return s;
  int components;
  nvjpegChromaSubsampling_t subsampling;
  return nvjpegGetImageInfo(h, data, len, &components, &subsampling, widths, heights);
}

// Decode `data` on `stream` into planes the caller allocates in device
// memory (`planes` of them, at the sizes vtc_jpeg_info gives): `output` 0 the
// luma (NVJPEG_OUTPUT_Y), 1 Y, Cb and Cr (NVJPEG_OUTPUT_YUV), 2 the components
// as coded (NVJPEG_OUTPUT_UNCHANGED).
int vtc_jpeg_decode(const unsigned char* data, size_t len, int planes, int output,
                    unsigned char* y, size_t y_pitch, unsigned char* cb, size_t cb_pitch,
                    unsigned char* cr, size_t cr_pitch, unsigned char* k, size_t k_pitch,
                    cudaStream_t stream) {
  nvjpegStatus_t s;
  nvjpegHandle_t h = handle(&s);
  if (s != NVJPEG_STATUS_SUCCESS) return s;
  if (!t_state.state) {
    s = nvjpegJpegStateCreate(h, &t_state.state);
    if (s != NVJPEG_STATUS_SUCCESS) return s;
  }
  nvjpegImage_t img = {};
  unsigned char* channels[4] = {y, cb, cr, k};
  size_t pitches[4] = {y_pitch, cb_pitch, cr_pitch, k_pitch};
  for (int c = 0; c < planes && c < 4; ++c) {
    img.channel[c] = channels[c];
    img.pitch[c] = pitches[c];
  }
  nvjpegOutputFormat_t format = output == 2   ? NVJPEG_OUTPUT_UNCHANGED
                                : output == 1 ? NVJPEG_OUTPUT_YUV
                                              : NVJPEG_OUTPUT_Y;
  s = nvjpegDecode(h, t_state.state, data, len, format, &img, stream);
  if (s != NVJPEG_STATUS_SUCCESS) return s;
  cudaError_t err = cudaStreamSynchronize(stream);
  return err == cudaSuccess ? 0 : 1000 + err;
}

// Upsample each of the `n` planes (3, or 4 with K in modes 2 and 3) by its
// factors and convert into the uint8 [h, w, 3] RGB `out` on `stream` (mode 0:
// R, G, B planes; 1: YCbCr; 2: CMYK; 3: YCCK); returns cudaGetLastError().
int vtc_ycc_to_rgb(const Plane* planes, int n, int w, int h, int mode, unsigned char* out,
                   int out_pitch, cudaStream_t stream) {
  Planes arg = {};
  for (int c = 0; c < n && c < 4; ++c) arg.plane[c] = planes[c];
  const int pairs = (w + 1) / 2;
  dim3 grid((pairs + kPairsPerBlock - 1) / kPairsPerBlock, h);
  ycc_to_rgb_kernel<<<grid, kPairsPerBlock, 0, stream>>>(arg, w, h, mode, out, out_pitch);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
