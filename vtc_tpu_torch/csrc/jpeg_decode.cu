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
// ceil(h/2)); a grayscale image gives its Y plane (NVJPEG_OUTPUT_Y). nvJPEG's
// own RGB output upsamples the chroma otherwise than libjpeg-turbo, 1.28-4.88
// levels off PIL per channel on 4:2:0 images, so the upsampling and the
// colour conversion are done here, by `ycc_to_rgb_kernel`, as libjpeg-turbo
// does them:
//
// * "fancy" upsampling (jdsample.c): h2v2_fancy_upsample (a vertical 3:1
//   column sum with the row above or below, then a horizontal 3:1 mix with
//   biases 8 and 7, >> 4), h2v1_fancy_upsample ((3 cur + prev + 1) >> 2,
//   (3 cur + next + 2) >> 2) and h1v2_fancy_upsample (biases 1 and 2, >> 2).
//   At the left and right edges and at the top and bottom rows (jdmainct.c's
//   context rows) the edge sample stands in for the missing neighbour, which
//   gives the edge columns' special cases of jdsample.c. A plane 2 samples
//   wide or less is box-replicated where it is upsampled horizontally, as
//   jinit_upsampler chooses (h2v1_upsample, h2v2_upsample), and so is 4:1:1
//   and 4:1:0 chroma, upsampled 4 times across and 1 or 2 times down
//   (int_upsample: each sample repeated over its 4 x vf box);
// * YCbCr -> RGB with the integer tables of jdcolor.c (build_ycc_rgb_table,
//   SCALEBITS 16), each result clamped to 0-255.
//
// The wrapper refuses other samplings (Cb and Cr sampled apart, a chroma plane
// sampled above the luma, factors such as 1 x 4) by name. The kernel computes
// the planes' padded width and height only where the cropped image needs
// them: output pixel (x, y) reads chroma column x / hf, rows y / vf and its
// neighbour.
//
// Bound: it reads w*h + 2*cw*ch bytes and writes 3*w*h; at thumbnail sizes
// (480 x 360: 0.86 MB) that is 0.26 us at 3.35 TB/s, so the launch and the
// decode's synchronizations set its time. One thread writes one output
// pixel pair (the two pixels of a horizontally upsampled chroma sample share
// its column sums); a block is 128 pairs of one row.
//
// Return codes: 0, an nvjpegStatus_t (1-10), or 1000 + a cudaError_t.

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <cstdint>
#include <mutex>

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

__device__ __forceinline__ int sample(const uint8_t* p, int pitch, int row, int col) {
  return p[static_cast<size_t>(row) * pitch + col];
}

// The chroma of output pixels (x0, y) and (x0 + 1, y), x0 even, from a plane
// of cw x ch samples upsampled by hf x vf (hf 1, 2 or 4, vf 1 or 2).
__device__ __forceinline__ void upsample_pair(const uint8_t* p, int pitch, int cw, int ch,
                                              int hf, int vf, int x0, int y, int out[2]) {
  if (hf == 4 || (hf == 2 && cw <= 2)) {
    // int_upsample, h2v1_upsample, h2v2_upsample: box replication; x0 is
    // even, so both pixels lie in one box
    out[0] = out[1] = sample(p, pitch, y / vf, x0 / hf);
    return;
  }
  if (hf == 1) {
    for (int i = 0; i < 2; ++i) {
      int x = min(x0 + i, cw - 1);  // the pixel past an odd width is cropped
      if (vf == 1) {
        out[i] = sample(p, pitch, y, x);
      } else {  // h1v2_fancy_upsample
        int r = y >> 1;
        int below = y & 1;
        int rn = below ? min(r + 1, ch - 1) : max(r - 1, 0);
        out[i] = (3 * sample(p, pitch, r, x) + sample(p, pitch, rn, x) + (below ? 2 : 1)) >> 2;
      }
    }
    return;
  }
  int c = x0 >> 1;
  int cl = max(c - 1, 0), cr = min(c + 1, cw - 1);
  if (vf == 1) {  // h2v1_fancy_upsample
    int cur = 3 * sample(p, pitch, y, c);
    out[0] = (cur + sample(p, pitch, y, cl) + 1) >> 2;
    out[1] = (cur + sample(p, pitch, y, cr) + 2) >> 2;
    return;
  }
  // h2v2_fancy_upsample: column sums with the nearer row weighted 3
  int r = y >> 1;
  int rn = (y & 1) ? min(r + 1, ch - 1) : max(r - 1, 0);
  int s = 3 * sample(p, pitch, r, c) + sample(p, pitch, rn, c);
  int sl = 3 * sample(p, pitch, r, cl) + sample(p, pitch, rn, cl);
  int sr = 3 * sample(p, pitch, r, cr) + sample(p, pitch, rn, cr);
  out[0] = (3 * s + sl + 8) >> 4;
  out[1] = (3 * s + sr + 7) >> 4;
}

__device__ __forceinline__ uint8_t clamp255(int v) {
  return static_cast<uint8_t>(min(max(v, 0), 255));
}

__global__ void ycc_to_rgb_kernel(const uint8_t* __restrict__ y, int y_pitch,
                                  const uint8_t* __restrict__ cb, int cb_pitch,
                                  const uint8_t* __restrict__ cr, int cr_pitch, int w, int h,
                                  int cw, int ch, int hf, int vf, uint8_t* __restrict__ out,
                                  int out_pitch) {
  int x0 = 2 * (blockIdx.x * kPairsPerBlock + threadIdx.x);
  int row = blockIdx.y;
  if (x0 >= w || row >= h) return;
  int cbv[2], crv[2];
  upsample_pair(cb, cb_pitch, cw, ch, hf, vf, x0, row, cbv);
  upsample_pair(cr, cr_pitch, cw, ch, hf, vf, x0, row, crv);
  uint8_t* o = out + static_cast<size_t>(row) * out_pitch + 3 * x0;
  for (int i = 0; i < 2 && x0 + i < w; ++i) {
    int luma = sample(y, y_pitch, row, x0 + i);
    int dcb = cbv[i] - 128, dcr = crv[i] - 128;
    // arithmetic shifts of signed ints, as jdcolor.c's RIGHT_SHIFT
    o[3 * i + 0] = clamp255(luma + ((kCrR * dcr + kHalf) >> 16));
    o[3 * i + 1] = clamp255(luma + ((-kCbG * dcb + kHalf - kCrG * dcr) >> 16));
    o[3 * i + 2] = clamp255(luma + ((kCbB * dcb + kHalf) >> 16));
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
// memory: with planes = 3, Y, Cb and Cr at their own sizes
// (NVJPEG_OUTPUT_YUV); with planes = 1, the luma (NVJPEG_OUTPUT_Y).
int vtc_jpeg_decode(const unsigned char* data, size_t len, int planes, unsigned char* y,
                    size_t y_pitch, unsigned char* cb, size_t cb_pitch, unsigned char* cr,
                    size_t cr_pitch, cudaStream_t stream) {
  nvjpegStatus_t s;
  nvjpegHandle_t h = handle(&s);
  if (s != NVJPEG_STATUS_SUCCESS) return s;
  if (!t_state.state) {
    s = nvjpegJpegStateCreate(h, &t_state.state);
    if (s != NVJPEG_STATUS_SUCCESS) return s;
  }
  nvjpegImage_t img = {};
  img.channel[0] = y;
  img.pitch[0] = y_pitch;
  if (planes == 3) {
    img.channel[1] = cb;
    img.pitch[1] = cb_pitch;
    img.channel[2] = cr;
    img.pitch[2] = cr_pitch;
  }
  s = nvjpegDecode(h, t_state.state, data, len,
                   planes == 3 ? NVJPEG_OUTPUT_YUV : NVJPEG_OUTPUT_Y, &img, stream);
  if (s != NVJPEG_STATUS_SUCCESS) return s;
  cudaError_t err = cudaStreamSynchronize(stream);
  return err == cudaSuccess ? 0 : 1000 + err;
}

// Upsample Cb and Cr (cw x ch, by hf x vf) and convert with Y (w x h) into
// the uint8 [h, w, 3] RGB `out` on `stream`; returns cudaGetLastError().
int vtc_ycc_to_rgb(const unsigned char* y, int y_pitch, const unsigned char* cb, int cb_pitch,
                   const unsigned char* cr, int cr_pitch, int w, int h, int cw, int ch, int hf,
                   int vf, unsigned char* out, int out_pitch, cudaStream_t stream) {
  int pairs = (w + 1) / 2;
  dim3 grid((pairs + kPairsPerBlock - 1) / kPairsPerBlock, h);
  ycc_to_rgb_kernel<<<grid, kPairsPerBlock, 0, stream>>>(y, y_pitch, cb, cb_pitch, cr,
                                                         cr_pitch, w, h, cw, ch, hf, vf, out,
                                                         out_pitch);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
