/* A pure-C consumer of cbindings/blitzar_tpu_api.h, run against the port's
 * libblitzar_tpu.so:
 *
 *     abi_consumer [backend [log2_n]]     backend 1 (CPU) or 2 (GPU, the
 *                                          default); log2_n 20 by default
 *
 * It initialises the library with the backend, checks the upstream
 * end-to-end commitments (reference rust/tests/src/main.rs:26-48), then
 * commits one column of 2^log2_n 32-byte counter scalars over the canonical
 * generators (benchmarks/pinned.py:22-40: row i = LE64(i K1) ||
 * LE64(i K2 + 1) || zeros), a cold call and three warm ones timed with
 * clock_gettime. It prints one JSON line:
 *
 *     {"rust_ok": true, "log2_n": 20, "hex": "...", "init_ms": t,
 *      "cold_ms": t, "warm_ms": [t, t, t]}
 *
 * and exits with 0, or with 1 when init fails and 2 on a wrong upstream
 * commitment or a warm commitment that differs from the cold one.
 *
 *     gcc -x c -std=c11 abi_consumer.c -I cbindings -L <dir> -lblitzar_tpu
 *         -Wl,-rpath,<dir> -o abi_consumer
 */
#define _POSIX_C_SOURCE 199309L

#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#include "blitzar_tpu_api.h"

static const uint32_t RUST_DATA[3][4] = {
    {2000, 7500, 5000, 1500},
    {5000, 0, 400000, 10},
    {2000 + 5000, 7500 + 0, 5000 + 400000, 1500 + 10},
};

static const char* RUST_EXPECTED[3] = {
    "04693a833b45966a788920e1aff45273d8b4ce9615faf062fbc092f436a9c761",
    "02feb2c3c6ee2c9c181d58c4253f9d32ec9f3d3199b54f7e37bc4301e4f84833",
    "1eeda3eafc6f2d85ebe31575e5bc5895f06dcd5a0682c79805dd39e7a8098d7a",
};

static const uint64_t K1 = 0x9E3779B97F4A7C15ULL;
static const uint64_t K2 = 0xC2B2AE3D27D4EB4FULL;

static double now_ms(void) {
  struct timespec t;
  clock_gettime(CLOCK_MONOTONIC, &t);
  return 1e3 * (double)t.tv_sec + 1e-6 * (double)t.tv_nsec;
}

static void to_hex(const uint8_t* bytes, char* out) {
  for (int i = 0; i < 32; ++i) {
    sprintf(out + 2 * i, "%02x", bytes[i]);
  }
  out[64] = '\0';
}

static void put_le64(uint8_t* out, uint64_t v) {
  for (int i = 0; i < 8; ++i) {
    out[i] = (uint8_t)(v >> (8 * i));
  }
}

int main(int argc, char** argv) {
  int backend = argc > 1 ? atoi(argv[1]) : SXT_GPU_BACKEND;
  int log2_n = argc > 2 ? atoi(argv[2]) : 20;
  uint64_t n = (uint64_t)1 << log2_n;

  double t0 = now_ms();
  struct sxt_config config = {backend, 0};
  if (sxt_init(&config) != 0) {
    fprintf(stderr, "sxt_init(%d) failed\n", backend);
    return 1;
  }
  double init_ms = now_ms() - t0;

  struct sxt_sequence_descriptor rust[3];
  for (int i = 0; i < 3; ++i) {
    rust[i].element_nbytes = 4;
    rust[i].n = 4;
    rust[i].data = (const uint8_t*)RUST_DATA[i];
    rust[i].is_signed = 0;
  }
  struct sxt_ristretto255_compressed rust_out[3];
  memset(rust_out, 0, sizeof(rust_out));
  sxt_curve25519_compute_pedersen_commitments(rust_out, 3, rust, 0);
  char hex[65];
  for (int i = 0; i < 3; ++i) {
    to_hex(rust_out[i].ristretto_bytes, hex);
    if (strcmp(hex, RUST_EXPECTED[i]) != 0) {
      fprintf(stderr, "upstream commitment %d: %s, expected %s\n", i, hex, RUST_EXPECTED[i]);
      return 2;
    }
  }

  uint8_t* rows = calloc(n, 32);
  if (rows == NULL) {
    fprintf(stderr, "out of memory\n");
    return 1;
  }
  for (uint64_t i = 0; i < n; ++i) {
    put_le64(rows + 32 * i, i * K1);
    put_le64(rows + 32 * i + 8, i * K2 + 1);
  }
  struct sxt_sequence_descriptor column = {32, n, rows, 0};
  struct sxt_ristretto255_compressed cold, warm;
  t0 = now_ms();
  sxt_curve25519_compute_pedersen_commitments(&cold, 1, &column, 0);
  double cold_ms = now_ms() - t0;
  double warm_ms[3];
  for (int r = 0; r < 3; ++r) {
    t0 = now_ms();
    sxt_curve25519_compute_pedersen_commitments(&warm, 1, &column, 0);
    warm_ms[r] = now_ms() - t0;
    if (memcmp(&warm, &cold, sizeof(cold)) != 0) {
      fprintf(stderr, "warm commitment %d differs from the cold one\n", r);
      return 2;
    }
  }
  free(rows);
  to_hex(cold.ristretto_bytes, hex);
  printf("{\"rust_ok\": true, \"log2_n\": %d, \"hex\": \"%s\", \"init_ms\": %.6f, \"cold_ms\": %.6f, "
         "\"warm_ms\": [%.6f, %.6f, %.6f]}\n",
         log2_n, hex, init_ms, cold_ms, warm_ms[0], warm_ms[1], warm_ms[2]);
  return 0;
}
