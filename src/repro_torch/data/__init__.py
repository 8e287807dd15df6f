"""Host-side data: synthetic datasets, label-skew partitions and the
federated round batches, numpy copies of :mod:`repro.data` that draw the
same numbers from the same seeds."""
