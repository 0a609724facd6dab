"""DSP ops: basics, biquads/SVFs, GEQ design, absorption, orthogonal matrices."""
