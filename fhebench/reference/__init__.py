"""The plain reference: TFHE over Torus32 words in torch (``tfhe.py``) and
the cleartext answers (``truth.py``).  It imports nothing of the program
under test."""
