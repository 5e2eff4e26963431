/* Reversal of the PNG Average (3) and Paeth (4) row filters of an 8-bit
 * grayscale image (one byte a pixel), in place.
 *
 * Each byte of such a row depends on the byte just reconstructed to its
 * left, so the reversal is a serial walk that numpy cannot vectorise; the
 * None, Sub and Up rows are reversed in numpy (data/png.py). Called once a
 * row with the row's `n` filtered bytes in `cur` and the previous
 * reconstructed row in `prev` (all zeros for the first row). Returns 0, or
 * -1 for a filter type other than 3 or 4.
 */
#include <stdint.h>
#include <stdlib.h>

static uint8_t paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
    if (pa <= pb && pa <= pc) return (uint8_t)a;
    if (pb <= pc) return (uint8_t)b;
    return (uint8_t)c;
}

int png_unfilter_row(int filter, uint8_t *cur, const uint8_t *prev, int n) {
    int i;
    if (n <= 0) return 0;
    if (filter == 3) {
        cur[0] = (uint8_t)(cur[0] + (prev[0] >> 1));
        for (i = 1; i < n; ++i) cur[i] = (uint8_t)(cur[i] + ((cur[i - 1] + prev[i]) >> 1));
        return 0;
    }
    if (filter == 4) {
        cur[0] = (uint8_t)(cur[0] + prev[0]);
        for (i = 1; i < n; ++i) cur[i] = (uint8_t)(cur[i] + paeth(cur[i - 1], prev[i], prev[i - 1]));
        return 0;
    }
    return -1;
}
