// The head dim 256 instances of flash_attention_bwd.cu, a translation
// unit and a library of their own: the wide instances' templates would
// double the longest build, and kernels/_build.py compiles the units in
// parallel.  kernels/flash_attention.py loads this library for D = 256.
#define TMX_HEAD_DIM 256
#include "flash_attention_bwd.cu"
