// The native host path of the PyTorch port's input pipeline
// (ldm_tf2_tpu_torch/data/native/__init__.py binds it with ctypes).
//
// A training step's host time goes to four things: TFRecord framing and
// CRC32C, the tf.train.Example walk, JPEG decode, and the image transform
// (/127.5 - 1, centred pad-to-square, nearest resize with half-pixel
// centres, flip).  All four are here, behind a plain C interface, so that
// the loaders' decode threads run them outside the GIL.  The Python path
// (data/tfrecord.py, data/example_proto.py, data/dataset.py) stays the
// reference: a decoded batch is bit-equal to it where libjpeg decodes as
// PIL does (tests/test_torch_native_loader.py).
//
// The JPEG part is compiled only with -DLDM_NATIVE_JPEG (and -ljpeg); a
// host without libjpeg's headers builds the rest, and
// ldm_native_has_jpeg() says which was built.
//
// Build (the binding does this at first use, into build/ldm_tf2_tpu_torch/):
//   g++ -O3 -shared -fPIC -std=c++17 -DLDM_NATIVE_JPEG tfrecord_native.cc -o lib.so -ljpeg

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#ifdef LDM_NATIVE_JPEG
#include <csetjmp>

#include <jpeglib.h>
#endif

namespace {

// ---------------------------------------------------------------- crc32c --
// CRC-32C (Castagnoli), slice-by-8, as data/tfrecord.py's crc32c.

uint32_t g_tables[8][256];
bool g_tables_ready = false;

void init_tables() {
  if (g_tables_ready) return;
  const uint32_t poly = 0x82F63B78u;  // reflected Castagnoli
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t crc = i;
    for (int b = 0; b < 8; ++b) crc = (crc >> 1) ^ ((crc & 1) ? poly : 0);
    g_tables[0][i] = crc;
  }
  for (int t = 1; t < 8; ++t)
    for (uint32_t i = 0; i < 256; ++i)
      g_tables[t][i] =
          (g_tables[t - 1][i] >> 8) ^ g_tables[0][g_tables[t - 1][i] & 0xFF];
  g_tables_ready = true;
}

uint32_t crc32c(const uint8_t* data, size_t len) {
  init_tables();
  uint32_t crc = 0xFFFFFFFFu;
  while (len >= 8) {
    uint32_t lo, hi;
    memcpy(&lo, data, 4);
    memcpy(&hi, data + 4, 4);
    lo ^= crc;
    crc = g_tables[7][lo & 0xFF] ^ g_tables[6][(lo >> 8) & 0xFF] ^
          g_tables[5][(lo >> 16) & 0xFF] ^ g_tables[4][lo >> 24] ^
          g_tables[3][hi & 0xFF] ^ g_tables[2][(hi >> 8) & 0xFF] ^
          g_tables[1][(hi >> 16) & 0xFF] ^ g_tables[0][hi >> 24];
    data += 8;
    len -= 8;
  }
  while (len--) crc = (crc >> 8) ^ g_tables[0][(crc ^ *data++) & 0xFF];
  return crc ^ 0xFFFFFFFFu;
}

uint32_t masked_crc(const uint8_t* data, size_t len) {
  uint32_t crc = crc32c(data, len);
  return ((crc >> 15) | (crc << 17)) + 0xA282EAD8u;
}

// ------------------------------------------------------------- tfrecords --

// A record file mapped read-only, and its records' payloads.
struct RecordFile {
  const uint8_t* data = nullptr;  // the mapping (null for an empty file)
  size_t size = 0;
  std::vector<size_t> offsets;  // payload offsets
  std::vector<size_t> lengths;  // payload lengths

  ~RecordFile() {
    if (data) munmap(const_cast<uint8_t*>(data), size);
  }
};

// --------------------------------------------------------------- protobuf --
// Minimal wire walker for tf.train.Example (schema in data/example_proto.py).

bool read_varint(const uint8_t* buf, size_t len, size_t* pos, uint64_t* out) {
  uint64_t result = 0;
  int shift = 0;
  while (*pos < len) {
    uint8_t b = buf[(*pos)++];
    result |= uint64_t(b & 0x7F) << shift;
    if (!(b & 0x80)) {
      *out = result;
      return true;
    }
    shift += 7;
    if (shift > 63) return false;
  }
  return false;
}

struct Field {
  uint64_t number;
  int wire;
  const uint8_t* data;  // for wire 2
  size_t len;
  uint64_t value;  // for wire 0
};

// Iterate fields of a message; callback returns false to stop.
template <typename F>
bool for_each_field(const uint8_t* buf, size_t len, F&& f) {
  size_t pos = 0;
  while (pos < len) {
    uint64_t tag;
    if (!read_varint(buf, len, &pos, &tag)) return false;
    Field fld;
    fld.number = tag >> 3;
    fld.wire = int(tag & 7);
    if (fld.wire == 0) {
      if (!read_varint(buf, len, &pos, &fld.value)) return false;
      fld.data = nullptr;
      fld.len = 0;
    } else if (fld.wire == 2) {
      uint64_t l;
      if (!read_varint(buf, len, &pos, &l)) return false;
      if (pos + l > len) return false;
      fld.data = buf + pos;
      fld.len = size_t(l);
      pos += l;
    } else if (fld.wire == 5) {
      fld.data = buf + pos;
      fld.len = 4;
      pos += 4;
    } else if (fld.wire == 1) {
      fld.data = buf + pos;
      fld.len = 8;
      pos += 8;
    } else {
      return false;
    }
    if (!f(fld)) return true;
  }
  return true;
}

// Find the Feature submessage for `name` inside a serialized Example.
bool find_feature(const uint8_t* rec, size_t len, const char* name,
                  const uint8_t** out, size_t* out_len) {
  size_t name_len = strlen(name);
  bool found = false;
  for_each_field(rec, len, [&](const Field& ex) {
    if (ex.number != 1 || ex.wire != 2) return true;  // features
    for_each_field(ex.data, ex.len, [&](const Field& feats) {
      if (feats.number != 1 || feats.wire != 2) return true;  // map entry
      const uint8_t* key = nullptr;
      size_t key_len = 0;
      const uint8_t* val = nullptr;
      size_t val_len = 0;
      for_each_field(feats.data, feats.len, [&](const Field& kv) {
        if (kv.number == 1 && kv.wire == 2) {
          key = kv.data;
          key_len = kv.len;
        } else if (kv.number == 2 && kv.wire == 2) {
          val = kv.data;
          val_len = kv.len;
        }
        return true;
      });
      if (key && val && key_len == name_len &&
          memcmp(key, name, name_len) == 0) {
        *out = val;
        *out_len = val_len;
        found = true;
        return false;
      }
      return true;
    });
    return !found;
  });
  return found;
}

// ------------------------------------------------------------------ jpeg --

#ifdef LDM_NATIVE_JPEG
struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}
#endif

}  // namespace

extern "C" {

uint32_t ldm_crc32c(const uint8_t* data, size_t len) {
  return crc32c(data, len);
}

int ldm_native_has_jpeg() {
#ifdef LDM_NATIVE_JPEG
  return 1;
#else
  return 0;
#endif
}

// Map a record file and index its records; null where it cannot be read,
// a record is truncated, or (with verify_crc) a CRC does not match.
void* ldm_tfrecord_open(const char* path, int verify_crc) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  auto* rf = new RecordFile();
  rf->size = size_t(st.st_size);
  if (rf->size > 0) {
    void* map = mmap(nullptr, rf->size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (map == MAP_FAILED) {
      close(fd);
      delete rf;
      return nullptr;
    }
    rf->data = static_cast<const uint8_t*>(map);
  }
  close(fd);

  size_t pos = 0;
  const uint8_t* d = rf->data;
  while (pos + 12 <= rf->size) {
    uint64_t length;
    memcpy(&length, d + pos, 8);  // little-endian host (x86, ARM)
    if (verify_crc) {
      uint32_t stored;
      memcpy(&stored, d + pos + 8, 4);
      if (masked_crc(d + pos, 8) != stored) {
        delete rf;
        return nullptr;
      }
    }
    size_t payload = pos + 12;
    if (length > rf->size || payload + length + 4 > rf->size) {
      delete rf;
      return nullptr;  // truncated
    }
    if (verify_crc) {
      uint32_t stored;
      memcpy(&stored, d + payload + length, 4);
      if (masked_crc(d + payload, size_t(length)) != stored) {
        delete rf;
        return nullptr;
      }
    }
    rf->offsets.push_back(payload);
    rf->lengths.push_back(size_t(length));
    pos = payload + length + 4;
  }
  return rf;
}

long ldm_tfrecord_num_records(void* h) {
  return long(static_cast<RecordFile*>(h)->offsets.size());
}

const uint8_t* ldm_tfrecord_record(void* h, long i, size_t* len) {
  auto* rf = static_cast<RecordFile*>(h);
  if (i < 0 || size_t(i) >= rf->offsets.size()) return nullptr;
  *len = rf->lengths[size_t(i)];
  return rf->data + rf->offsets[size_t(i)];
}

void ldm_tfrecord_close(void* h) { delete static_cast<RecordFile*>(h); }

// The framing scan of the indexed loader (data/indexed.py::build_index):
// returns N and allocates *out as [N * 2] int64 (payload offset, payload
// length) pairs; payloads are skipped with fseek, so a shard costs one
// seek a record, not a full read.  The caller frees *out with ldm_free.
long ldm_tfrecord_scan(const char* path, int64_t** out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  std::vector<int64_t> entries;
  uint8_t header[12];
  int64_t pos = 0;
  for (;;) {
    if (fread(header, 1, 12, f) != 12) break;
    uint64_t length;
    memcpy(&length, header, 8);
    entries.push_back(pos + 12);
    entries.push_back(int64_t(length));
    pos += 12 + int64_t(length) + 4;
    if (fseek(f, long(pos), SEEK_SET) != 0) {
      fclose(f);
      return -1;
    }
  }
  fclose(f);
  if (entries.empty()) {
    // an empty file is a scan of 0 records, not a failure
    *out = nullptr;
    return 0;
  }
  *out = static_cast<int64_t*>(malloc(entries.size() * sizeof(int64_t)));
  if (!*out) return -1;
  memcpy(*out, entries.data(), entries.size() * sizeof(int64_t));
  return long(entries.size() / 2);
}

void ldm_free(void* p) { free(p); }

// One record's positioned read (the indexed loader's fetch): the bytes
// read, or -1 where the file cannot be opened or the read is short.
long ldm_pread(const char* path, int64_t offset, int64_t length,
               uint8_t* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  if (fseek(f, long(offset), SEEK_SET) != 0) {
    fclose(f);
    return -1;
  }
  size_t got = fread(out, 1, size_t(length), f);
  fclose(f);
  return got == size_t(length) ? long(got) : -1;
}

// Extract the raw bytes of feature `name`'s first bytes_list entry.
long ldm_example_bytes(const uint8_t* rec, size_t len, const char* name,
                       const uint8_t** out, size_t* out_len) {
  const uint8_t* feat;
  size_t feat_len;
  if (!find_feature(rec, len, name, &feat, &feat_len)) return -1;
  bool found = false;
  for_each_field(feat, feat_len, [&](const Field& kind) {
    if (kind.number != 1 || kind.wire != 2) return true;  // bytes_list
    for_each_field(kind.data, kind.len, [&](const Field& v) {
      if (v.number == 1 && v.wire == 2) {
        *out = v.data;
        *out_len = v.len;
        found = true;
        return false;
      }
      return true;
    });
    return !found;
  });
  return found ? long(*out_len) : -1;
}

// Extract int64_list feature `name` into out (up to max_out); returns count.
long ldm_example_int64s(const uint8_t* rec, size_t len, const char* name,
                        int64_t* out, long max_out) {
  const uint8_t* feat;
  size_t feat_len;
  if (!find_feature(rec, len, name, &feat, &feat_len)) return -1;
  long n = 0;
  for_each_field(feat, feat_len, [&](const Field& kind) {
    if (kind.number != 3 || kind.wire != 2) return true;  // int64_list
    for_each_field(kind.data, kind.len, [&](const Field& v) {
      if (v.number != 1) return true;
      if (v.wire == 2) {  // packed
        size_t pos = 0;
        uint64_t val;
        while (pos < v.len && read_varint(v.data, v.len, &pos, &val)) {
          if (n < max_out) out[n] = int64_t(val);
          ++n;
        }
      } else if (v.wire == 0) {
        if (n < max_out) out[n] = int64_t(v.value);
        ++n;
      }
      return true;
    });
    return true;
  });
  return n;
}

#ifdef LDM_NATIVE_JPEG
// JPEG decode -> RGB u8 -> /127.5 - 1 -> centred pad-to-square -> nearest
// resize (half-pixel centres) -> optional flip -> [image_size, image_size, 3]
// float32, data/dataset.py::process_image's chain.  0, or -1 where libjpeg
// rejects the data.
int ldm_decode_and_process(const uint8_t* jpeg, size_t len, int image_size,
                           int flip, float* out) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, jpeg, static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  const int w = int(cinfo.output_width);
  const int h = int(cinfo.output_height);
  std::vector<uint8_t> pixels(size_t(w) * h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = pixels.data() + size_t(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);

  // centred pad-to-square geometry
  const int side = w > h ? w : h;
  int pad_top = 0, pad_left = 0;
  if (h > w) pad_left = (h - w) / 2;
  if (w > h) pad_top = (w - h) / 2;

  // nearest resize with half-pixel centres
  const double scale = double(side) / image_size;
  for (int oy = 0; oy < image_size; ++oy) {
    int sy = int((oy + 0.5) * scale);
    if (sy >= side) sy = side - 1;
    const int iy = sy - pad_top;
    for (int ox = 0; ox < image_size; ++ox) {
      int sx = int((ox + 0.5) * scale);
      if (sx >= side) sx = side - 1;
      int ix = sx - pad_left;
      if (flip) ix = w - 1 - ix;
      float* o = out + (size_t(oy) * image_size + ox) * 3;
      if (iy < 0 || iy >= h || ix < 0 || ix >= w) {
        // the chain normalizes before it pads: the padding is 0.0
        o[0] = o[1] = o[2] = 0.0f;
      } else {
        const uint8_t* p = pixels.data() + (size_t(iy) * w + ix) * 3;
        o[0] = float(p[0]) / 127.5f - 1.0f;
        o[1] = float(p[1]) / 127.5f - 1.0f;
        o[2] = float(p[2]) / 127.5f - 1.0f;
      }
    }
  }
  return 0;
}
#endif  // LDM_NATIVE_JPEG

}  // extern "C"
