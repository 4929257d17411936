// The head dim 192 instances of flash_attention_bwd.cu, a translation
// unit and a library of their own: the wide instances' templates would
// double the longest build, and kernels/_build.py compiles the units in
// parallel.  kernels/flash_attention.py loads this library for D = 192.
#define TMX_HEAD_DIM 192
#include "flash_attention_bwd.cu"
