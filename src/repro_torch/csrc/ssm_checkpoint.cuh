// The steps between the states that the Mamba selective scan's forward
// (ssm_scan.cu, under grad mode) keeps for its backward (ssm_scan_bwd.cu),
// which recomputes one interval at a time: both sources take it from here,
// and both walk tiles of two intervals.  Both C entries also take the
// caller's interval (kernels/ssm_scan/bwd.py, CHECKPOINT, which sizes the
// checkpoints) and refuse any other, so a change on one side fails the
// launch instead of reading checkpoints of another layout.
#pragma once

constexpr int kSsmCheckpoint = 8;
