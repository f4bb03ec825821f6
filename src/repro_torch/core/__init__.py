"""GSPN-2 algorithm: tap normalisation, directional dispatch, attention."""
