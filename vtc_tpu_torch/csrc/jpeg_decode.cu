// JPEG decode on the card with nvJPEG, for the port's data path.
//
// Not a port of a TPU kernel: the JAX package decodes its thumbnails on the
// host with PIL (vtc_tpu/data/datasets.py, ImTextDataset.__getitem__), and
// the machine with the card has no PIL. nvJPEG ships with the CUDA toolkit;
// this file is its plain C binding for ctypes (vtc_tpu_torch/data/image_io.py):
//
// * one nvjpegHandle_t per process, made on first use;
// * one nvjpegJpegState_t per calling thread (the loader's workers are
//   threads), destroyed when the thread exits;
// * each decode runs on the stream the caller passes (the wrapper gives each
//   thread a stream of its own and allocates the output on it, so no other
//   stream's work orders or races the decode) and synchronizes it before it
//   returns, so the output can be copied to the host at once.
//
// Output: interleaved RGB (NVJPEG_OUTPUT_RGBI) for a colour image, the
// luma plane (NVJPEG_OUTPUT_Y) for a grayscale one, into device memory the
// caller allocates. nvJPEG's IDCT and chroma upsampling are not
// libjpeg-turbo's, so the pixels differ from PIL's by a few levels; the
// tolerance is measured by chip_smoke.py and stated in PERF.md.
//
// Return codes: 0, an nvjpegStatus_t (1-10), or 1000 + a cudaError_t.

#include <cuda_runtime.h>
#include <nvjpeg.h>

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

}  // namespace

extern "C" {

// The size of the image in `data` (its components and subsampling are read
// from the header by the wrapper).
int vtc_jpeg_info(const unsigned char* data, size_t len, int* width, int* height) {
  nvjpegStatus_t s;
  nvjpegHandle_t h = handle(&s);
  if (s != NVJPEG_STATUS_SUCCESS) return s;
  int components, widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
  nvjpegChromaSubsampling_t css;
  s = nvjpegGetImageInfo(h, data, len, &components, &css, widths, heights);
  if (s != NVJPEG_STATUS_SUCCESS) return s;
  *width = widths[0];
  *height = heights[0];
  return 0;
}

// Decode `data` into `out` (device memory, rows `pitch` bytes apart) on
// `stream`: luma_only = 0 writes [height, width, 3] RGB, 1 the
// [height, width] luma.
int vtc_jpeg_decode(const unsigned char* data, size_t len, int luma_only,
                    unsigned char* out, size_t pitch, cudaStream_t stream) {
  nvjpegStatus_t s;
  nvjpegHandle_t h = handle(&s);
  if (s != NVJPEG_STATUS_SUCCESS) return s;
  if (!t_state.state) {
    s = nvjpegJpegStateCreate(h, &t_state.state);
    if (s != NVJPEG_STATUS_SUCCESS) return s;
  }
  nvjpegImage_t img = {};
  img.channel[0] = out;
  img.pitch[0] = pitch;
  s = nvjpegDecode(h, t_state.state, data, len,
                   luma_only ? NVJPEG_OUTPUT_Y : NVJPEG_OUTPUT_RGBI, &img, stream);
  if (s != NVJPEG_STATUS_SUCCESS) return s;
  cudaError_t err = cudaStreamSynchronize(stream);
  return err == cudaSuccess ? 0 : 1000 + err;
}

}  // extern "C"
