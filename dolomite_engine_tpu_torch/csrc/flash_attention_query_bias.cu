// The query-bias form of the flash kernels (kQueryBias: T5's relative bias over (query,
// key) pairs, with its gradient), compiled apart from `flash_attention.cu`'s other forms
// so the two translation units build in parallel. The kernels are that file's templates;
// its `dolo_flash_fwd` / `dolo_flash_bwd` run the pre-pass and call
// `dolo_flash_query_bias` here for bias_mode 2.
#define DOLO_FLASH_QUERY_BIAS_UNIT
#include "flash_attention.cu"
