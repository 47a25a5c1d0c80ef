"""The corpus schema (HDF5 and its .npz twin), its writer and readers, the
float64 host whitening, the data pipeline and the waveform synthesis."""
