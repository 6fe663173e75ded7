// fortread.cc - native reader for big-endian Fortran sequential
// unformatted files (the RADRRTM / RADSRTM coefficient binaries).
//
// Reference parity: the ifsrrtm/rrtm_kgb*.F90 and srtm_kgb*.F90 loaders
// read these files with Fortran `READ(NULRAD)` on a big-endian
// unformatted unit (Makefile_include.gfortran:9 -fconvert=big-endian).
// Each sequential record is framed by 4-byte big-endian byte counts.
// This C++ equivalent is the framework's native data-loader for the
// same artifacts, exposed with a C ABI for ctypes.
//
// Build: g++ -O2 -shared -fPIC -o libfortread.so fortread.cc

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

struct File {
  FILE* fp = nullptr;
};

uint32_t be32(const unsigned char* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

uint64_t be64(const unsigned char* p) {
  uint64_t hi = be32(p);
  uint64_t lo = be32(p + 4);
  return (hi << 32) | lo;
}

}  // namespace

extern "C" {

void* fort_open(const char* path) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return nullptr;
  File* f = new File{fp};
  return f;
}

void fort_close(void* handle) {
  File* f = static_cast<File*>(handle);
  if (!f) return;
  if (f->fp) fclose(f->fp);
  delete f;
}

// Read the next sequential record's payload length in bytes without
// consuming it; -1 on EOF/error.
long fort_next_record_bytes(void* handle) {
  File* f = static_cast<File*>(handle);
  unsigned char hdr[4];
  long pos = ftell(f->fp);
  if (fread(hdr, 1, 4, f->fp) != 4) return -1;
  fseek(f->fp, pos, SEEK_SET);
  return static_cast<long>(be32(hdr));
}

// Read one record as big-endian float64 values into `out` (capacity
// `cap` doubles). Returns the number of doubles read, or -1 on error.
long fort_read_f64(void* handle, double* out, long cap) {
  File* f = static_cast<File*>(handle);
  unsigned char hdr[4];
  if (fread(hdr, 1, 4, f->fp) != 4) return -1;
  long nbytes = static_cast<long>(be32(hdr));
  long n = nbytes / 8;
  if (n > cap) return -1;
  std::vector<unsigned char> buf(nbytes);
  if (fread(buf.data(), 1, nbytes, f->fp) != size_t(nbytes)) return -1;
  unsigned char trailer[4];
  if (fread(trailer, 1, 4, f->fp) != 4) return -1;
  if (be32(trailer) != uint32_t(nbytes)) return -1;
  for (long i = 0; i < n; ++i) {
    uint64_t bits = be64(buf.data() + i * 8);
    double v;
    memcpy(&v, &bits, 8);
    out[i] = v;
  }
  return n;
}

// Skip one record; returns 0 on success.
int fort_skip(void* handle) {
  File* f = static_cast<File*>(handle);
  unsigned char hdr[4];
  if (fread(hdr, 1, 4, f->fp) != 4) return -1;
  long nbytes = static_cast<long>(be32(hdr));
  if (fseek(f->fp, nbytes + 4, SEEK_CUR) != 0) return -1;
  return 0;
}

}  // extern "C"
