"""The data path: wav IO and DSP (`audio`), the 438-d music features
(`features`), the min-max `Normalizer`, the AIOZ-GDance dataset
(`dataset`), seeded stand-in data (`synthetic`), the offline dataset
builder (`create_dataset`) and the native batch prefetcher
(`native_loader`)."""
