// Native index-mapping helpers for the Megatron-style pretraining data pipeline.
//
// Parity: reference `data/megatron/utils/helpers.cpp` (233 LoC, pybind11). This build exposes a
// plain C ABI instead (loaded via ctypes — pybind11 is not available in this image); callers
// allocate the numpy output buffers so no ownership crosses the boundary.
//
// build: g++ -O3 -Wall -shared -std=c++17 -fPIC helpers.cpp -o helpers.so

#include <cstdint>

// Token-window -> (document, offset) sample index. sample_idx has shape [num_samples + 1, 2]
// (flattened, caller-allocated): row i = (index into doc_idx, token offset in that document)
// where sample i covers seq_length + 1 tokens starting there, overlapping the next sample by
// one token.
template <typename DocIdxT>
static void build_sample_idx_impl(DocIdxT* sample_idx,
                                  const int32_t* sizes,
                                  const DocIdxT* doc_idx,
                                  const int32_t seq_length,
                                  const int64_t num_samples) {
    int64_t sample_index = 0;
    int64_t doc_idx_index = 0;
    int64_t doc_offset = 0;

    sample_idx[0] = 0;
    sample_idx[1] = 0;
    ++sample_index;

    while (sample_index <= num_samples) {
        int64_t remaining = seq_length + 1;
        while (remaining != 0) {
            int64_t doc_length = static_cast<int64_t>(sizes[doc_idx[doc_idx_index]]) - doc_offset;
            remaining -= doc_length;
            if (remaining <= 0) {
                // window ends inside this document; next window starts at its last token
                doc_offset += remaining + doc_length - 1;
                remaining = 0;
            } else {
                ++doc_idx_index;
                doc_offset = 0;
            }
        }
        sample_idx[2 * sample_index] = static_cast<DocIdxT>(doc_idx_index);
        sample_idx[2 * sample_index + 1] = static_cast<DocIdxT>(doc_offset);
        ++sample_index;
    }
}

extern "C" {

// Greedy max-error weighted blending: for each output sample pick the dataset whose achieved
// sample count lags its target weight the most. dataset_index[i] = which dataset, and
// dataset_sample_index[i] = running per-dataset counter.
void build_blending_indices(int16_t* dataset_index,
                            int64_t* dataset_sample_index,
                            const double* weights,
                            const int32_t num_datasets,
                            const int64_t size) {
    int64_t* current_samples = new int64_t[num_datasets];
    for (int32_t i = 0; i < num_datasets; ++i) current_samples[i] = 0;

    for (int64_t sample_idx = 0; sample_idx < size; ++sample_idx) {
        double sample_idx_double = sample_idx > 1 ? static_cast<double>(sample_idx) : 1.0;
        int32_t max_error_index = 0;
        double max_error = weights[0] * sample_idx_double - static_cast<double>(current_samples[0]);
        for (int32_t d = 1; d < num_datasets; ++d) {
            double error = weights[d] * sample_idx_double - static_cast<double>(current_samples[d]);
            if (error > max_error) {
                max_error = error;
                max_error_index = d;
            }
        }
        dataset_index[sample_idx] = static_cast<int16_t>(max_error_index);
        dataset_sample_index[sample_idx] = current_samples[max_error_index];
        current_samples[max_error_index] += 1;
    }
    delete[] current_samples;
}

void build_sample_idx_int32(int32_t* sample_idx,
                            const int32_t* sizes,
                            const int32_t* doc_idx,
                            const int32_t seq_length,
                            const int64_t num_samples) {
    build_sample_idx_impl<int32_t>(sample_idx, sizes, doc_idx, seq_length, num_samples);
}

void build_sample_idx_int64(int64_t* sample_idx,
                            const int32_t* sizes,
                            const int64_t* doc_idx,
                            const int32_t seq_length,
                            const int64_t num_samples) {
    build_sample_idx_impl<int64_t>(sample_idx, sizes, doc_idx, seq_length, num_samples);
}

}  // extern "C"
