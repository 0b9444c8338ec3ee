"""The plain reference the benchmark holds the program against.

Plain PyTorch on the inputs the benchmark made (the genotypes as
written, the trait and the covariates), in float64 unless a caller asks
for a lower precision (the control).  It imports nothing of the program
and takes nothing the program made: the GRM, its eigendecomposition,
the null variances, the per-SNP refits and the REML fit are all worked
out again here, from the published definitions of DISSECT's analyses.
"""
