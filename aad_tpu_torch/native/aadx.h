/* aadx — native host codec for the AAD bitstream format.
 *
 * aad_tpu_torch's own copy of aad_tpu/native/aadx.h, kept in step with it.
 *
 * A from-scratch C++ implementation of the same wire format the JAX/Pallas
 * pipeline speaks (format spec: SURVEY.md appendices; semantics pinned by
 * the shared conformance suite). Serves as the low-latency host path for
 * small files / CLI cold starts and as a second, independent oracle in
 * tests. C ABI for ctypes consumption.
 */
#ifndef AADX_H_
#define AADX_H_

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

enum AadxStatus {
  AADX_OK = 0,
  AADX_INVALID_ARGUMENT = 1,
  AADX_INVALID_FORMAT = 2,
  AADX_INSUFFICIENT_BUFFER = 3,
  AADX_INSUFFICIENT_DATA = 4,
};

typedef struct AadxInfo {
  uint32_t format_version;
  uint32_t codec_version;
  uint32_t num_channels;
  uint32_t num_samples;
  uint32_t sampling_rate;
  uint32_t bits_per_sample;
  uint32_t block_size;
  uint32_t num_samples_per_block;
  uint32_t ch_process_method;
} AadxInfo;

/* Parse the 31-byte stream header. */
int aadx_parse_header(const uint8_t* data, size_t size, AadxInfo* info);

/* Decode a whole stream. pcm receives channel-major samples
 * (pcm[ch * num_samples + t], int16-valued int32). capacity is the number
 * of int32 slots available in pcm. */
int aadx_decode(const uint8_t* data, size_t size, int32_t* pcm,
                size_t capacity, AadxInfo* info);

/* Encode a whole stream. pcm is channel-major as above. Returns the byte
 * size written through out_size. */
int aadx_encode(const int32_t* pcm, uint32_t num_channels,
                uint32_t num_samples, uint32_t sampling_rate,
                uint32_t bits_per_sample, uint32_t max_block_size,
                uint32_t ch_process_method, uint32_t num_encode_trials,
                uint8_t* out, size_t capacity, size_t* out_size);

/* Encode a whole stream in block-independent (parallel) mode: chunks of
 * chunk_blocks blocks each restart from the default predictor state and
 * encode sequentially within (full trial warm-up included), so the output
 * equals the concatenation of per-chunk sequential encodes — the byte
 * contract of the JAX engines' parallel_blocks=True mode with
 * parallel_chunk_blocks. chunk_blocks=1 is the plain per-block mode.
 * warm_passes > 0 adds Jacobi warm refinement: each pass walks every
 * non-final chunk trials=0 and hands its exit state to the next chunk as
 * that chunk's head seed for the following pass — the byte contract of
 * parallel_warm_passes (ops/encode.py::encode_blocks_parallel). */
int aadx_encode_parallel(const int32_t* pcm, uint32_t num_channels,
                         uint32_t num_samples, uint32_t sampling_rate,
                         uint32_t bits_per_sample, uint32_t max_block_size,
                         uint32_t ch_process_method,
                         uint32_t num_encode_trials, uint32_t chunk_blocks,
                         uint32_t warm_passes, uint8_t* out, size_t capacity,
                         size_t* out_size);

/* Streaming-chunk encode: encode num_samples (whole blocks, or a final
 * short tail) continuing a sequential chain. No file header is written.
 * state_io is (num_channels, 9) int32 — h[4], w[4], idx per channel —
 * and prev_io is (num_channels, num_samples_per_block) int32 holding the
 * previous block in the channel-transformed domain; both are read (prev
 * only when blocks_before > 0) and written back for the next chunk.
 * Byte-concatenation across chunks equals the one-shot aadx_encode
 * payload — the native mirror of the JAX streaming carry
 * (aad_tpu/ops/encode.py::encode_stream_blocks_carry). */
int aadx_encode_chunk(const int32_t* pcm, uint32_t num_channels,
                      uint32_t num_samples, uint32_t sampling_rate,
                      uint32_t bits_per_sample, uint32_t max_block_size,
                      uint32_t ch_process_method, uint32_t num_encode_trials,
                      uint32_t blocks_before, int32_t* state_io,
                      int32_t* prev_io, uint8_t* out, size_t capacity,
                      size_t* out_size);

/* Streaming-chunk decode: data holds whole blocks back to back (no file
 * header; the final block may be zero-padded to block_size on the wire),
 * cfg carries the stream's header fields, and num_samples per channel are
 * emitted into pcm (channel-major, capacity int32 slots). */
int aadx_decode_blocks(const uint8_t* data, size_t size, uint32_t num_samples,
                       int32_t* pcm, size_t capacity, const AadxInfo* cfg);

/* Size helpers, mirroring the block-geometry rules. */
int aadx_block_geometry(uint32_t max_block_size, uint32_t num_channels,
                        uint32_t bits_per_sample, uint32_t* block_size,
                        uint32_t* num_samples_per_block);

/* Upper bound on encoded size for capacity planning. */
size_t aadx_encode_bound(uint32_t num_channels, uint32_t num_samples,
                         uint32_t bits_per_sample, uint32_t max_block_size);

uint32_t aadx_abi_version(void);

#ifdef __cplusplus
}
#endif

#endif /* AADX_H_ */
