/* example.c — self-checking libwaverange round trip (the analogue of the
   reference's examples/fortran/example_fort.f90): synthesize a 64^3
   field, encode at tolrel, decode, verify the Linf error bound.

   Build:  python -m waverange.native.libwaverange
           gcc -O2 -o example example.c -L../../build/lib -lwaverange \
               -Wl,-rpath,$PWD/../../build/lib -lm
*/
#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include "../../build/include/waverange.h"

int main(void) {
  const int n = 64;
  const unsigned long ntot = (unsigned long)n * n * n;
  const double tolrel = 1e-6;

  unsigned char nlaymax;
  unsigned long ntot_enc_max;
  setup_wr(n, n, n, &nlaymax, &ntot_enc_max);
  printf("nlaymax=%d ntot_enc_max=%lu\n", (int)nlaymax, ntot_enc_max);

  double *fld = malloc(ntot * sizeof(double));
  double *orig = malloc(ntot * sizeof(double));
  for (unsigned long j = 0; j < ntot; j++) {
    int x = j % n, y = (j / n) % n, z = j / n / n;
    fld[j] = 10.0 * sin(x / 16.0) * sin(y / 16.0) * cos(z / 16.0);
  }
  memcpy(orig, fld, ntot * sizeof(double));

  double cutoff[1] = {tolrel};
  double tolabs, midval, halfspanval;
  unsigned char wlev, nlay;
  unsigned long ntot_enc;
  double deps_vec[8], minval_vec[8];
  unsigned long len_enc_vec[8];
  unsigned char *data_enc = malloc(ntot_enc_max);

  /* NOTE: the encoder clobbers fld (same contract as the reference). */
  encoding_wrap(n, n, n, fld, 1, 1, 1, 1, cutoff, &tolabs, &midval,
                &halfspanval, &wlev, &nlay, &ntot_enc, deps_vec,
                minval_vec, len_enc_vec, data_enc);
  printf("encoded: nlay=%d ntot_enc=%lu ratio=%.3f tolabs=%.3e\n",
         (int)nlay, ntot_enc, (double)ntot_enc / (ntot * 8), tolabs);

  double *rec = malloc(ntot * sizeof(double));
  decoding_wrap(n, n, n, rec, &tolabs, &midval, &halfspanval, &wlev,
                &nlay, &ntot_enc, deps_vec, minval_vec, len_enc_vec,
                data_enc);

  double err = 0, amax = 0;
  for (unsigned long j = 0; j < ntot; j++) {
    double e = fabs(rec[j] - orig[j]);
    if (e > err) err = e;
    if (fabs(orig[j]) > amax) amax = fabs(orig[j]);
  }
  printf("err_linf_abs=%.3e err_linf_rel=%.3e\n", err, err / amax);
  int ok = err <= 1.3 * tolrel * amax;
  printf(ok ? "PASS\n" : "FAIL\n");
  free(fld); free(orig); free(rec); free(data_enc);
  return ok ? 0 : 1;
}
