// The wide and segmented instances of domain decoding (domdec.cu), in a
// translation unit of their own so that nvcc compiles them beside the
// others.
#define BT_DOMDEC_WIDE
#include "domdec.cu"
