"""Signal front end: packed-real complex helpers, STFT and spectrogram transforms."""
