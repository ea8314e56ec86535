/* jconfig.h as libjpeg-turbo 2.1.5 (jpeg 6.2 ABI) installs it, altered: the comments after the
   notice above removed, every declaration unchanged. */
#define JPEG_LIB_VERSION  62
#define LIBJPEG_TURBO_VERSION  2.1.5
#define LIBJPEG_TURBO_VERSION_NUMBER  2001005
#define C_ARITH_CODING_SUPPORTED 1
#define D_ARITH_CODING_SUPPORTED 1
#define MEM_SRCDST_SUPPORTED 1
#define WITH_SIMD 1
#define BITS_IN_JSAMPLE  8
