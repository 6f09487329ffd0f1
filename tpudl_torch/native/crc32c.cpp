// CRC-32C (Castagnoli) over a byte buffer, slicing by 8: the checksum TF's
// tensor bundles keep for each tensor. Host code, built with g++ at first
// use by tpudl_torch/native/crc.py.
#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

uint32_t table[8][256];
bool ready = false;

void init() {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1u)));
    table[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; ++i)
    for (int t = 1; t < 8; ++t)
      table[t][i] = (table[t - 1][i] >> 8) ^ table[0][table[t - 1][i] & 0xFF];
  ready = true;
}

}  // namespace

extern "C" {

int tpudl_crc_abi_version() { return 1; }

// crc32c(data[0:n]) extended from ``crc`` (0 for a fresh checksum).
uint32_t tpudl_crc32c_extend(uint32_t crc, const uint8_t* data, size_t n) {
  if (!ready) init();
  uint32_t c = ~crc;
  while (n && (reinterpret_cast<uintptr_t>(data) & 7)) {
    c = table[0][(c ^ *data++) & 0xFF] ^ (c >> 8);
    --n;
  }
  while (n >= 8) {
    uint64_t w;
    std::memcpy(&w, data, 8);
    w ^= c;
    c = table[7][w & 0xFF] ^ table[6][(w >> 8) & 0xFF] ^
        table[5][(w >> 16) & 0xFF] ^ table[4][(w >> 24) & 0xFF] ^
        table[3][(w >> 32) & 0xFF] ^ table[2][(w >> 40) & 0xFF] ^
        table[1][(w >> 48) & 0xFF] ^ table[0][(w >> 56) & 0xFF];
    data += 8;
    n -= 8;
  }
  while (n--) c = table[0][(c ^ *data++) & 0xFF] ^ (c >> 8);
  return ~c;
}

}  // extern "C"
