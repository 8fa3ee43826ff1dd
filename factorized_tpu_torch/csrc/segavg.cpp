// The data readers' host loops in C++, with a plain C interface bound by
// ctypes (factorized_tpu_torch/native.py builds it with the host C++
// compiler at first use):
//
// - segment_average: the mean of each word's frame window of a video's
//   feature rows (the real MOSI reader, data/mosi.py; the reference's
//   data_loader.py:62-101), each column summed in double in frame order;
// - pad_truncate / pad_truncate_batch: segments padded with zeros or
//   truncated to their last max_len rows, then NaN and inf mapped and the
//   values clipped (mfm_moud.py:197-209, 267-272; mfm_you.py:231-241).
//
// No -ffast-math or -march=native: the sums must keep their order and
// rounding, so the results equal data/segavg.py's bit for bit.

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// Average feats[starts[w]:ends[w], :] per word into out[w, :].
// Empty/degenerate ranges produce zero vectors; NaN and -inf entries
// are zeroed (data_loader.py:99-100 semantics).
void segment_average(const float* feats, int64_t n_frames, int64_t dim,
                     const int64_t* starts, const int64_t* ends,
                     int64_t n_words, float* out) {
    for (int64_t w = 0; w < n_words; ++w) {
        int64_t s = starts[w];
        int64_t e = ends[w];
        if (s < 0) s = 0;
        if (e > n_frames) e = n_frames;
        float* dst = out + w * dim;
        if (e <= s) {
            std::memset(dst, 0, sizeof(float) * dim);
            continue;
        }
        const double inv = 1.0 / static_cast<double>(e - s);
        for (int64_t d = 0; d < dim; ++d) {
            double acc = 0.0;
            for (int64_t f = s; f < e; ++f) {
                acc += static_cast<double>(feats[f * dim + d]);
            }
            float v = static_cast<float>(acc * inv);
            if (std::isnan(v) || (std::isinf(v) && v < 0)) v = 0.0f;
            dst[d] = v;
        }
    }
}

// Pad/truncate a (len, dim) segment to (max_len, dim):
// - len > max_len: keep the LAST max_len rows (data_loader.py:148-152)
// - len < max_len: zero-pad, zeros FIRST if left_pad else after
void pad_truncate(const float* data, int64_t len, int64_t dim,
                  int64_t max_len, int left_pad, float* out) {
    if (len >= max_len) {
        std::memcpy(out, data + (len - max_len) * dim,
                    sizeof(float) * max_len * dim);
        return;
    }
    const int64_t pad = max_len - len;
    if (left_pad) {
        std::memset(out, 0, sizeof(float) * pad * dim);
        std::memcpy(out + pad * dim, data, sizeof(float) * len * dim);
    } else {
        std::memcpy(out, data, sizeof(float) * len * dim);
        std::memset(out + len * dim, 0, sizeof(float) * pad * dim);
    }
}

// Batched pad/truncate with clipping (mfm_moud.py:267-272) and
// nan_to_num (mfm_you.py:231-241): segments are concatenated in
// `data`, with per-segment offsets/lengths.
void pad_truncate_batch(const float* data, const int64_t* offsets,
                        const int64_t* lens, int64_t n_segs, int64_t dim,
                        int64_t max_len, int left_pad, float clip,
                        int do_nan, float* out) {
    for (int64_t i = 0; i < n_segs; ++i) {
        pad_truncate(data + offsets[i] * dim, lens[i], dim, max_len,
                     left_pad, out + i * max_len * dim);
    }
    const int64_t total = n_segs * max_len * dim;
    if (do_nan) {
        for (int64_t j = 0; j < total; ++j) {
            float v = out[j];
            if (std::isnan(v)) out[j] = 0.0f;
            else if (std::isinf(v)) out[j] = v > 0 ? 3.4e38f : -3.4e38f;
        }
    }
    if (clip > 0) {
        for (int64_t j = 0; j < total; ++j) {
            if (out[j] > clip) out[j] = clip;
            else if (out[j] < -clip) out[j] = -clip;
        }
    }
}

}  // extern "C"
