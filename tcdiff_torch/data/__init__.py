"""The serving half of the data path: wav IO and DSP (`audio`), the 438-d
music features (`features`) and the min-max `Normalizer`."""
