// The instances of fs3 domain decoding for blocks of up to 32 warps and
// for the segmented groups (MODE 2-4 of fs3_domdec.cu), in a translation
// unit of their own so that nvcc compiles them beside the others.
#define BT_FS3_DOMDEC_WIDE
#include "fs3_domdec.cu"
