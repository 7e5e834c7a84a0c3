// C API of the mpc-verde-tpu native host engine.
//
// The reference's host-side layer is pandas CSV reads plus per-(t, k) Python
// loops rebuilding reference tensors every step (SURVEY.md §2.1:
// Trajectory_tracking_le_LTI.py:104-128, leitura.py:98-127).  This library is
// the native equivalent: bulk CSV ingest, vectorized reference synthesis,
// stage-window assembly, and an independent float64 Riccati LQR solver used
// as a golden cross-check for the JAX solver's unconstrained path.
#pragma once
#include <cstdint>

extern "C" {

// Count data rows of a CSV file (excluding the header). Returns -1 on error.
int64_t mv_csv_rows(const char* path);

// Parse a path CSV with columns x,y[,uref] (header required).  Writes n rows
// into x/y/uref (each of capacity cap).  Missing uref column fills 0.4 (the
// lane_change.csv base speed).  Returns rows written or -1 on error.
int64_t mv_load_path_csv(const char* path, double* x, double* y, double* uref,
                         int64_t cap);

// Heading phi[i] = atan2(dy, dx) of consecutive samples, phi[0] = 0; the
// reference's +2pi unwrap when requested (lane_change.py:59-67).
void mv_path_heading(const double* x, const double* y, int64_t n, int unwrap,
                     double* phi);

// Lateral-error reference synthesis (Trajectory_tracking_le_LTI.py:104-128,
// vectorized): out is row-major (n, 4) = [y_ref, phi_ref, r_ref, delta_ref].
void mv_lateral_error_refs(const double* x, const double* y, int64_t n,
                           double dt, double ar, double br, int unwrap,
                           double* out);

// Stage-window gather: out[t, k, :] = refs[min(t + k, n - 1), :].
// refs row-major (n, np); out row-major (nsim, nt, np).
void mv_stage_window(const double* refs, int64_t n, int64_t np_, int64_t nt,
                     int64_t nsim, double* out);

// Finite-horizon discrete LQR via Riccati recursion (float64, independent
// implementation for cross-checking the JAX solver).  Row-major A (nx,nx),
// B (nx,nu), Q (nx,nx), R (nu,nu); returns open-loop controls us (N, nu)
// from x0 and the optimal cost.  nu <= 4, nx <= 16.
double mv_lqr_riccati(const double* A, const double* B, const double* Q,
                      const double* R, const double* Qf, int64_t nx,
                      int64_t nu, int64_t N, const double* x0, double* us);

}  // extern "C"
