// The head dim 128 instances of flash_attention_bwd.cu, a translation
// unit and a library of their own: with the others in one unit it was the
// longest of the build, and kernels/_build.py compiles the units in
// parallel.  kernels/flash_attention.py loads this library for D = 128.
#define TMX_HEAD_DIM 128
#include "flash_attention_bwd.cu"
